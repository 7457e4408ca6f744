"""The one builder and loader of the port's compiled libraries
(``ops/_build.py``), over a small g++ library on the CPU."""

import ctypes
import hashlib
import shutil
import subprocess

import pytest

from tpu_vector_db_torch.ops import _build

SOURCE = 'extern "C" int vdb_plus(int x) { return x + 41; }\n'


def _signatures(lib):
    lib.vdb_plus.argtypes = [ctypes.c_int]
    lib.vdb_plus.restype = ctypes.c_int


@pytest.mark.parametrize("case", ["fresh", "cached", "refused",
                                  "no compiler", "shared with jax"])
def test_one_loader_outcomes(tmp_path, monkeypatch, case):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    src_dir = tmp_path / "src"
    src_dir.mkdir()
    source = src_dir / "plus.cpp"
    source.write_text("int broken = ;\n" if case == "refused" else SOURCE)
    if case == "shared with jax":
        monkeypatch.setattr(_build, "NATIVE_DIR", src_dir)
        (src_dir / "libplus-000000000000.so").write_bytes(b"older source")

    def declare():
        library = _build.Library(source, _signatures, name="libplus")
        if case != "shared with jax":
            library.out_dir = tmp_path / "build"
        return library

    if case == "cached":
        assert declare().load() is not None
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    if case == "no compiler":
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    runs, warnings = [], []
    real_run = subprocess.run
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda *a, **k: runs.append(a[0][0])
                        or real_run(*a, **k))
    monkeypatch.setattr(_build.logger, "warning",
                        lambda *a, **k: warnings.append(a))

    library = declare()
    lib = library.load()
    assert library.load() is lib            # once a process
    if case in ("refused", "no compiler"):
        assert lib is None and library.lib is None
        assert len(warnings) == 1
        assert runs == ["g++"]              # tried once, no second try
        assert not list(tmp_path.rglob("*.tmp"))
        return
    assert lib.vdb_plus(1) == 42 and not warnings
    built = list(library.out_dir.glob("libplus*.so"))
    assert [lib._name] == [str(p) for p in built]
    if case == "cached":
        assert runs == []
    elif case == "fresh":
        assert runs == ["g++"]
        assert built[0].name.startswith("libplus_")
    else:   # the JAX loader's name; the older source's build is gone
        digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
        assert built[0].name == f"libplus-{digest}.so"
        assert set(runs) == {"g++"}     # -march=native, or without it


def test_a_kernel_that_does_not_build_raises_each_time(tmp_path,
                                                       monkeypatch):
    """A kernel has no other path: its failure reaches the caller, and the
    next launch tries again."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    source = tmp_path / "kernel.cu"
    source.write_text(SOURCE)
    library = _build.Library(source, _signatures)
    library.out_dir = tmp_path / "build"
    for _ in range(2):
        with pytest.raises(FileNotFoundError):
            library.load()
    assert library.lib is None
