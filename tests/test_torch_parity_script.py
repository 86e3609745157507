"""scripts/parity_torch.py end to end: `--synthetic --device cpu` writes a
tiny checkpoint (the full 152064-token vocabulary: the byte tokenizer emits
the real special ids), dataset and scores, then runs the five steps through
the port alone: step 1 SKIPs without a reference checkout, step 2 PASSes
against transformers' Qwen2, step 3 SKIPs without videos, step 4 prints its
recall and SKIPs the comparison without --expected, step 5 PASSes; no FAIL,
exit 0, and no kernel launch on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_parity_torch_synthetic_self_test():
    env = dict(os.environ, USE_TF="0")      # transformers' import skips TensorFlow
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "parity_torch.py"),
                           "--synthetic", "--device", "cpu",
                           "--reference", str(REPO / "no_reference_here")],
                          cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"{proc.stderr[-2000:]}\n{proc.stdout[-2000:]}"
    out = proc.stdout
    assert "SKIP  1 tokenizer goldens" in out
    assert "PASS  2 logit parity" in out and "PASS  5 train trajectory" in out
    assert "SKIP  3 feature parity" in out and "computed (t2v_r1=" in out
    assert "FAIL" not in out
    assert 'launches: {"flash_fwd": 0, "flash_fwd_lse": 0' in out
