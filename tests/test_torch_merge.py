"""The k <= 32 merge of both scans' candidate lists
(tpu_vector_db_torch/ops/ivf_scan.py ``merge_small_k``, the kernel
``merge_small_k`` of csrc/topk_common.cuh) and chip_smoke.py's ptxas
report of the kernels' registers.

On the CPU ``merge_small_k`` takes its plain version, which is held
against the JAX package's ``ops/topk.py::merge_topk`` on tie-free lists
made with numpy from a seed: keys and ids equal exactly. The kernel is held
bit for bit against the plain version by the card-only tests (marked
``gpu``) at every k and list count the scans give it, with ties across the
k-th key, -0.0 against +0.0, empty lists and fewer live candidates than k:
no arithmetic happens in a merge, so nothing may differ.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_vector_db.ops.topk import merge_topk as jax_merge_topk

from tpu_vector_db_torch.ops.ivf_scan import merge_small_k, merge_small_k_plain
from tpu_vector_db_torch.ops.launches import LAUNCHES

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

KS = (1, 10, 31, 32)


def sorted_lists(rng, q_n, n_lists, k, empty=0.0, keys=None):
    """(Q, n_lists * k) candidates: each list of k sorted by key
    descending, then id ascending; ids distinct in a query; a share
    ``empty`` of the lists all -inf (the ids then say nothing). Keys are
    distinct unless given."""
    if keys is None:
        keys = (rng.permutation(q_n * n_lists * k) / (q_n * n_lists * k)
                ).astype(np.float32).reshape(q_n, n_lists, k)
    ids = np.stack([rng.permutation(n_lists * k)
                    for _ in range(q_n)]).reshape(q_n, n_lists, k)
    keys = keys.copy()
    keys[rng.random((q_n, n_lists)) < empty] = -np.inf
    order = np.lexsort((ids, -keys), axis=-1)
    keys = np.take_along_axis(keys, order, -1)
    ids = np.take_along_axis(ids, order, -1)
    return keys.reshape(q_n, -1), ids.reshape(q_n, -1).astype(np.int32)


@pytest.mark.parametrize("n_lists", [1, 2, 33, 512])
@pytest.mark.parametrize("k", KS)
def test_merge_plain_matches_jax(k, n_lists):
    """On tie-free lists, some all -inf, the plain merge returns what the
    JAX merge_topk returns on the same candidates: the same keys and the
    same ids wherever the key is finite (-1 elsewhere); the wrapper takes
    it for a CPU tensor and launches nothing."""
    rng = np.random.default_rng(100 + k + n_lists)
    keys, ids = sorted_lists(rng, 3, n_lists, k,
                             empty=0.3 if n_lists > 1 else 0.0)
    half = keys.shape[1] // 2
    want_k, want_i = jax_merge_topk(
        jnp.asarray(keys[:, :half]), jnp.asarray(ids[:, :half]),
        jnp.asarray(keys[:, half:]), jnp.asarray(ids[:, half:]), k)
    want_k, want_i = np.asarray(want_k), np.asarray(want_i)
    before = dict(LAUNCHES)
    got_k, got_i = (t.numpy() for t in merge_small_k(
        torch.from_numpy(keys), torch.from_numpy(ids), k))
    assert LAUNCHES == before
    np.testing.assert_array_equal(got_k, want_k)
    fin = np.isfinite(want_k)
    np.testing.assert_array_equal(got_i[fin], want_i[fin])
    assert np.all(got_i[~fin] == -1)


def test_merge_plain_fewer_candidates_than_k():
    """Fewer candidates than k: the tail is -inf with empty_id."""
    keys = torch.tensor([[0.5, -np.inf, 0.25]], dtype=torch.float32)
    ids = torch.tensor([[7, 3, 2]], dtype=torch.int32)
    got_k, got_i = merge_small_k_plain(keys, ids, 5, empty_id=0)
    assert got_k.tolist() == [[0.5, 0.25] + [-np.inf] * 3]
    assert got_i.tolist() == [[7, 2, 0, 0, 0]]


def test_merge_small_k_contract_errors():
    keys = torch.zeros((2, 20))
    ids = torch.zeros((2, 20), dtype=torch.int32)
    for k in (0, 33):
        with pytest.raises(ValueError, match="1 <= k <= 32"):
            merge_small_k(keys, ids, k)
    with pytest.raises(ValueError, match="same"):
        merge_small_k(keys, ids[:, :10], 5)
    with pytest.raises(ValueError, match="same"):
        merge_small_k(keys[0], ids[0], 5)


# ------------------------------------------- chip_smoke.py's ptxas report

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z12scan_small_kILi2ELi1ELb0EEv8ScanArgs' for 'sm_90a'
ptxas info    : Function properties for _Z12scan_small_kILi2ELi1ELb0EEv8ScanArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13merge_small_kPKfPKiiiPfPii' for 'sm_90a'
ptxas info    : Function properties for _Z13merge_small_kPKfPKiiiPfPii
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 396 bytes cmem[0]
ptxas info    : Compiling entry function '_Z17merge_topk_kernelPKfPKiiiiiPfPiS2_S3_i' for 'sm_90a'
ptxas info    : Function properties for _Z17merge_topk_kernelPKfPKiiiiiPfPiS2_S3_i
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 408 bytes cmem[0]
"""


def test_parse_ptxas_registers_and_spills():
    kernels = chip_smoke.parse_ptxas(REPORT)
    assert kernels == {
        "scan_small_k<2,1,0>": {"registers": 64, "spill_bytes": 0},
        "merge_small_k": {"registers": 40, "spill_bytes": 12},
        "merge_topk_kernel": {"registers": 30, "spill_bytes": 0},
    }


def test_ptxas_report_fresh_log_replaces_saved(tmp_path):
    saved = tmp_path / "lib.ptxas.txt"
    saved.write_text("an older report")
    assert chip_smoke.ptxas_report(REPORT, saved) == REPORT
    assert saved.read_text() == REPORT


def test_ptxas_report_cached_build_keeps_saved(tmp_path):
    """A library built before gives an empty log: the saved report is
    read and left as it was."""
    saved = tmp_path / "lib.ptxas.txt"
    saved.write_text(REPORT)
    assert chip_smoke.ptxas_report("", saved) == REPORT
    assert saved.read_text() == REPORT


def test_ptxas_report_none_without_one(tmp_path):
    saved = tmp_path / "lib.ptxas.txt"
    assert chip_smoke.ptxas_report("", saved) is None
    saved.write_text("")
    assert chip_smoke.ptxas_report("", saved) is None


@pytest.mark.parametrize("state", ["fresh", "cached", "cached_no_report"])
def test_phase_build_reports_registers(tmp_path, monkeypatch, capsys, state):
    """phase_build with a fake build: a fresh log, an empty log beside a
    saved report, or an empty log with none saved (a verbose build makes
    it). Every build line has real register counts and spills, and the
    saved report holds the compiler's report afterwards."""
    from tpu_vector_db_torch.ops import _build

    def fake_build(name, extra_flags=()):
        assert extra_flags == ("-Xptxas", "-v")
        return tmp_path / f"lib{name}.so", REPORT if state == "fresh" else ""

    verbose = []
    for name in chip_smoke.LIBRARIES:
        if state == "cached":
            (tmp_path / f"lib{name}.ptxas.txt").write_text(REPORT)
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(chip_smoke, "REPO", tmp_path)
    monkeypatch.setattr(chip_smoke, "verbose_build_log",
                        lambda name: verbose.append(name) or REPORT)
    chip_smoke.phase_build()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == len(chip_smoke.LIBRARIES)
    for line in lines:
        assert line["max_registers"] == 64
        assert line["kernels_with_spills"] == 1
        assert line["spill_bytes"] == {"merge_small_k": 12}
        assert line["built_now"] == (state == "fresh")
    assert sorted(verbose) == (sorted(chip_smoke.LIBRARIES)
                               if state == "cached_no_report" else [])
    for name in chip_smoke.LIBRARIES:
        assert (tmp_path / f"lib{name}.ptxas.txt").read_text() == REPORT


# ------------------------------------------------------- on the card only

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def assert_bit_equal(keys, ids, k, empty_id, dev):
    """The kernel against the plain version (on the CPU), bit for bit."""
    kt, it = torch.from_numpy(keys), torch.from_numpy(ids)
    want_k, want_i = merge_small_k_plain(kt, it, k, empty_id)
    got_k, got_i = merge_small_k(kt.to(dev), it.to(dev), k, empty_id)
    torch.cuda.synchronize()
    assert torch.equal(got_k.cpu().view(torch.int32),
                       want_k.view(torch.int32))
    assert torch.equal(got_i.cpu(), want_i)


@pytest.mark.gpu
@pytest.mark.parametrize("n_lists", [1, 2, 33, 512, 4224])
@pytest.mark.parametrize("k", KS)
def test_merge_small_k_matches_plain_on_card(k, n_lists):
    """Random lists, a third of them all -inf, at batch 1, 3 and 64 (the
    flat path's empty_id 0, the IVF path's -1)."""
    dev = _cuda()
    rng = np.random.default_rng(200 + k + n_lists)
    for q_n, empty_id in ((1, -1), (3, 0), (64, -1)):
        keys, ids = sorted_lists(rng, q_n, n_lists, k, empty=0.3)
        assert_bit_equal(keys, ids, k, empty_id, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("k", KS)
def test_merge_small_k_ties_straddle_kth_on_card(k):
    """Equal keys across the k-th: 3 larger keys, then 40 copies of one
    key in lists spread over every warp's slice of 4224 lists; the top k
    takes the lowest ids among the copies."""
    dev = _cuda()
    rng = np.random.default_rng(300 + k)
    n_lists = 4224
    keys = rng.uniform(-1.0, 0.4, (2, n_lists, k)).astype(np.float32)
    spread = np.linspace(0, n_lists - 1, 40).astype(int)
    keys[:, spread, 0] = 0.5
    keys[:, [7, 2000, 4000], 1 % k] = 0.75
    for empty_id in (0, -1):
        lists = sorted_lists(rng, 2, n_lists, k, keys=keys)
        assert_bit_equal(*lists, k, empty_id, dev)
        if k > 3:
            got_k, _ = merge_small_k(torch.from_numpy(lists[0]).to(dev),
                                     torch.from_numpy(lists[1]).to(dev), k)
            assert np.all(got_k.cpu().numpy()[:, 3:] == 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("k", KS)
def test_merge_small_k_signed_zero_on_card(k):
    """-0.0 and +0.0 tie: ordered by id, each key's bits kept."""
    dev = _cuda()
    rng = np.random.default_rng(400 + k)
    keys = np.where(rng.random((1, 40, k)) < 0.5, -0.0, 0.0).astype(
        np.float32)
    keys[0, :3, 0] = 1.0
    lists = sorted_lists(rng, 1, 40, k, keys=keys)
    for empty_id in (0, -1):
        assert_bit_equal(*lists, k, empty_id, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n_lists", [1, 33, 512])
def test_merge_small_k_few_live_on_card(n_lists):
    """Every list -inf, or 3 live candidates in all: the tail is -inf with
    empty_id (0 and -1)."""
    dev = _cuda()
    rng = np.random.default_rng(500 + n_lists)
    for k in KS:
        keys = np.full((2, n_lists, k), -np.inf, np.float32)
        for live in (0, min(3, n_lists * k)):
            flat = keys.reshape(2, -1).copy()
            flat[:, rng.permutation(flat.shape[1])[:live]] = rng.uniform(
                -1, 1, (2, live)).astype(np.float32)
            lists = sorted_lists(rng, 2, n_lists, k,
                                 keys=flat.reshape(2, n_lists, k))
            for empty_id in (0, -1):
                assert_bit_equal(*lists, k, empty_id, dev)

