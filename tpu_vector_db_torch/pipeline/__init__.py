"""Host-side helpers shared by the port's native bridges.

Only ``_native.py`` (the ctypes loader of ``native/*.cpp``) is here yet;
the embedding pipeline itself is not ported.
"""
