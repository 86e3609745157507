"""The port's fp32 VTG criteria against the JAX package's, on the CPU.
The fused CE streams the vocabulary in chunks; V=1000 with chunk 384 leaves
a ragged last chunk (the JAX side clamps and masks it, the port slices it
short). Tolerance: fp32, atol 1e-5 / rtol 1e-5."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from blim_tpu.scoring import criteria as jc

from blim_tpu_torch.core.constants import IGNORE_INDEX
from blim_tpu_torch.scoring import criteria as tc

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL, RTOL = 1e-5, 1e-5
B, W, D, V = 3, 7, 16, 1000


def _inputs(rng, lora=False):
    hidden = rng.standard_normal((B, W, D)).astype(np.float32)
    kernel = rng.standard_normal((D, V)).astype(np.float32) * 0.3
    labels = rng.integers(0, V, (B, W)).astype(np.int32)
    labels[:, 5:] = IGNORE_INDEX
    labels[0, 0] = V - 1          # the ragged last chunk's last column
    labels[1, 0] = 768            # first column of the ragged chunk
    labels[2, 0] = 767            # last column of a full chunk
    labels[2, 1:] = IGNORE_INDEX  # a row with one labeled token
    extra = ()
    if lora:
        extra = (rng.standard_normal((D, 4)).astype(np.float32) * 0.2,
                 rng.standard_normal((4, V)).astype(np.float32) * 0.2, 2.0)
    return hidden, kernel, labels, extra


def test_token_ce_from_logits_matches(rng):
    logits = rng.standard_normal((B, W, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, (B, W)).astype(np.int32)
    labels[0, :2] = IGNORE_INDEX
    tce, tv = tc.token_ce_from_logits(torch.from_numpy(logits), torch.from_numpy(labels))
    jce, jv = jc.token_ce_from_logits(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tce.numpy(), np.asarray(jce), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("chunk", [384, 256, 16384])
def test_ce_from_hidden_matches(rng, lora, chunk):
    hidden, kernel, labels, extra = _inputs(rng, lora)
    jextra = tuple(jnp.asarray(e) if isinstance(e, np.ndarray) else e for e in extra)
    textra = tuple(torch.from_numpy(e) if isinstance(e, np.ndarray) else e for e in extra)
    jce, jv = jc.ce_from_hidden(jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(labels),
                                *jextra, chunk=chunk)
    tce, tv = tc.ce_from_hidden(torch.from_numpy(hidden), torch.from_numpy(kernel),
                                torch.from_numpy(labels), *textra, chunk=chunk)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tce.numpy(), np.asarray(jce), atol=ATOL, rtol=RTOL)
    # and against the materialized logits
    logits = torch.from_numpy(hidden) @ torch.from_numpy(kernel)
    if lora:
        logits = logits + (torch.from_numpy(hidden) @ textra[0]) @ textra[1] * textra[2]
    dce, _ = tc.token_ce_from_logits(logits, torch.from_numpy(labels))
    np.testing.assert_allclose(tce.numpy(), dce.numpy(), atol=ATOL, rtol=RTOL)


def test_vtg_likelihood_from_hidden_matches(rng):
    hidden, kernel, labels, _ = _inputs(rng)
    j = jc.vtg_likelihood_from_hidden(jnp.asarray(hidden), jnp.asarray(kernel),
                                      jnp.asarray(labels))
    t = tc.vtg_likelihood_from_hidden(torch.from_numpy(hidden), torch.from_numpy(kernel),
                                      torch.from_numpy(labels))
    assert tuple(t.shape) == (B,)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)
