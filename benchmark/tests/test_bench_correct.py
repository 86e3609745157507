"""`correct` on the CPU at the tiny size: the reference agrees with the
program, the float8 control does not, and a run with its timed path broken
underneath comes out not correct for each fault such a cell can have."""

import numpy as np
import pytest
import torch

from benchmark.controls import faults
from benchmark.drivers import extract, rerank
from benchmark.reference import llm as ref_llm
from benchmark.reference import vit as ref_vit
from benchmark.tests import tiny


def _numbers(out):
    return {k: c["value"] for k, c in out["checks"].items()}


@pytest.mark.parametrize("finetuned", [True, False], ids=["ft", "zs"])
def test_rerank_reference_agrees_with_the_program(finetuned):
    out = rerank.run(tiny.context(tiny.rerank_cell(finetuned)))
    assert out["result"]["correct"], out["checks"]
    gaps = [v for k, v in _numbers(out).items() if k.endswith("_gap")]
    assert len(gaps) == (2 if finetuned else 1) and max(gaps) < 1e-4


def test_extract_reference_agrees_with_the_program():
    out = extract.run(tiny.context(tiny.extract_cell(), seconds=0.1))
    assert out["result"]["correct"], out["checks"]
    assert _numbers(out)["feature_rel_err"] < 1e-4


def test_data_parallel_ranks_agree_with_the_reference():
    out = rerank.run(tiny.context(tiny.rerank_cell(True, chips=2)))
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["device"]["count"] == 2


def test_rerank_control_fails_where_the_program_passes():
    ctx = tiny.context(tiny.rerank_cell(True))
    ctx["keep_state"] = True
    out = rerank.run(ctx)
    s = out["state"]
    feats = torch.from_numpy(s["inp"]["features"])
    pairs = [(c, v, False) for c, v in zip(range(8), range(8))]
    with torch.no_grad():
        want = ref_llm.vtg_scores(s["params"], s["mdl"], s["inp"]["captions"], feats, pairs,
                                  "MSRVTT", 96, s["lora"], s["scale"])
        got = ref_llm.vtg_scores(s["params"], s["mdl"], s["inp"]["captions"], feats, pairs,
                                 "MSRVTT", 96, s["lora"], s["scale"], quant=ref_llm.fake_fp8)
    control = float((got - want).abs().max())
    program = max(v for k, v in _numbers(out).items() if k.endswith("_gap"))
    assert control > tiny.TINY_LIMIT > 10 * program


def test_extract_control_fails_where_the_program_passes():
    ctx = tiny.context(tiny.extract_cell(), seconds=0.1)
    ctx["keep_state"] = True
    out = extract.run(ctx)
    s = out["state"]
    rounds = []
    with torch.no_grad():
        frames = s["frames"][:1]
        got = ref_vit.featurize(s["vit"], s["vd"], frames, quant=ref_vit.fake_fp8, record=rounds)
        want = ref_vit.replay(ref_vit.towers(s["vit"], s["vd"], frames), rounds)
    program = _numbers(out)
    assert ref_vit.relative_error(got[0], want) > tiny.TINY_LIMIT > 10 * program["feature_rel_err"]
    kept = [rounds for calls in s["kept"].values() for _out, rounds in calls]
    assert ref_vit.merge_shortfall(rounds) > 0.0 == max(map(ref_vit.merge_shortfall, kept))


def _unchanged_state(monkeypatch):
    from blim_tpu_torch.engine.rerank import RerankEngine

    monkeypatch.setattr(RerankEngine, "score_pairs_vtg_packed",
                        lambda self, banks, cap_idx, vid_idx: np.zeros(len(cap_idx), np.float32))


def _half_the_batch(monkeypatch):
    from blim_tpu_torch.models import videochat_flash as vcf
    from blim_tpu_torch.scoring import criteria

    real = criteria.ce_from_hidden

    def half(hidden, kernel, labels, *args, **kw):
        labels = labels.clone()
        labels[..., 1::2] = -100          # every other token left out of the mean
        return real(hidden, kernel, labels, *args, **kw)

    monkeypatch.setattr(vcf.criteria, "ce_from_hidden", half)


def _altered_answer(monkeypatch):
    from blim_tpu_torch.models import videochat_flash as vcf

    real = vcf.score_tvg_packed
    monkeypatch.setattr(vcf, "score_tvg_packed", lambda *a, **kw: real(*a, **kw) + 1e-2)


def no_exchange():
    """Every rank keeps its own shard's scores: the sums across ranks left
    out (run in each rank's process)."""
    from blim_tpu_torch.engine.rerank import RerankEngine

    RerankEngine._allreduce_scores = staticmethod(lambda scores: scores)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_batch, _altered_answer],
                         ids=["state-unchanged", "half-the-batch", "answer-altered"])
def test_rerank_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = rerank.run(tiny.context(tiny.rerank_cell(True)))
    assert out["result"]["correct"] is False, out["checks"]


def test_rerank_without_the_exchange_is_not_correct():
    from blim_tpu_torch.engine.rerank import RerankEngine

    ctx = tiny.context(tiny.rerank_cell(True, chips=2))
    ctx["hook"] = "benchmark.tests.test_bench_correct:no_exchange"
    real = RerankEngine.__dict__["_allreduce_scores"]
    try:
        out = rerank.run(ctx)
    finally:
        RerankEngine._allreduce_scores = real
    assert out["result"]["correct"] is False, out["checks"]


def _tome_altered(monkeypatch):
    from blim_tpu_torch.models import projector

    real = projector.compress_clip_tokens
    monkeypatch.setattr(projector, "compress_clip_tokens", lambda *a, **kw: real(*a, **kw) * 1.01)


def _half_the_clips(monkeypatch):
    from blim_tpu_torch.models import umt_vit

    real = umt_vit.encode_clips

    def half(params, clips, pos, cfg):
        out = real(params, clips, pos, cfg)
        return torch.cat([out[:, : out.shape[1] // 2], out[:, : out.shape[1] // 2]], dim=1)

    monkeypatch.setattr(umt_vit, "encode_clips", half)


def _worst_merges(monkeypatch):
    from blim_tpu_torch.models import projector

    monkeypatch.setattr(projector, "_bipartite_merge_indices",
                        faults.worst_merges(projector._bipartite_merge_indices))


@pytest.mark.parametrize("fault", [_tome_altered, _half_the_clips, _worst_merges],
                         ids=["answer-altered", "half-the-batch", "worst-merges"])
def test_extract_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = extract.run(tiny.context(tiny.extract_cell(), seconds=0.1))
    assert out["result"]["correct"] is False, out["checks"]


def test_merges_against_the_rule_read_a_shortfall(monkeypatch):
    """The decision stage that the features' comparison follows is held by
    itself: merges of the least similar tokens fall far short of ToMe's
    rule, while the features merged as they decided still agree."""
    _worst_merges(monkeypatch)
    out = extract.run(tiny.context(tiny.extract_cell(), seconds=0.1))
    numbers = _numbers(out)
    assert numbers["merge_shortfall"] > 0.1 and numbers["feature_rel_err"] < tiny.TINY_LIMIT
    assert out["result"]["correct"] is False


@pytest.mark.cuda
def test_readings_on_the_card():
    """The control at a cell's own size, on the card (benchmark/controls/
    readings.py runs it over many seeds; this runs one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys

    from benchmark import common

    out = subprocess.run([sys.executable, str(common.HERE / "controls" / "readings.py"),
                          "--workload", "vcf-extract-msrvtt", "--seeds", "5",
                          "--seconds", "3"], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
