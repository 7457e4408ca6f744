"""REST serving layer (aiohttp).

Counterpart of the reference's FastAPI app (main.py + api/routes/*,
SURVEY.md §2.E) — rebuilt on aiohttp with the full endpoint surface,
INCLUDING the batch/v1 API the reference defined but never mounted, and with
auth, rate limiting, metrics, and structured logging actually wired
(SURVEY.md §2.1 lists all four as dead code upstream).
"""
