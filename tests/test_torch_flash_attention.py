"""apex_tpu_torch flash attention and decode attention against apex_tpu on
the CPU.

The JAX side runs twice — its Pallas kernels in interpret mode
(``set_force_pallas(True)``) and its default path — against the port's
plain versions (what a CPU tensor takes).  f32 tolerance 2e-5 (the JAX
kernel's own parity bound); a bf16 cache compared in f32 at 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jfa
from apex_tpu.utils import set_force_pallas

from apex_tpu_torch.ops import flash_attention as tfa

B, H, S, D = 2, 2, 40, 16     # seq off every block multiple


@pytest.fixture(params=["pallas_interpret", "jax_default"])
def jax_path(request):
    set_force_pallas(True if request.param == "pallas_interpret" else None)
    yield request.param
    set_force_pallas(None)


def _qkv(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("case", ["causal", "non_causal", "kv_seqlens"])
def test_flash_attention_matches_jax(jax_path, case):
    q, k, v = _qkv(0)
    lens = np.array([S, 13], np.int32) if case == "kv_seqlens" else None
    causal = case == "causal"
    ref = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_seqlens=None if lens is None else jnp.asarray(lens))
    out = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_seqlens=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_fully_masked_row_is_zero():
    """kv_seqlens 0 masks every key: the l == 0 guard gives 0, no NaN."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1))
    out = tfa.flash_attention(q, k, v, kv_seqlens=torch.tensor([S, 0]))
    assert torch.isfinite(out).all()
    assert not out[1].any()


def test_dropout_and_grad_are_refused():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2))
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention(q, k, v, dropout=0.1, dropout_seed=0)
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="sq == sk"):
        tfa.flash_attention(q[:, :, :5], k, v, causal=True)


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
def test_decode_matches_jax_on_strided_cache(jax_path, cache_dtype):
    """Ragged lengths (1 token, mid-block, block edge, full cache) over a
    strided ``cache[:, layer, 0]`` view of a slot ring, as the model
    passes it."""
    b, S_, h, d, layers = 4, 160, 3, 16, 2
    rng = np.random.RandomState(3)
    q = rng.randn(b, h, d).astype(np.float32)
    ring = rng.randn(b, layers, 2, S_, h, d).astype(np.float32)
    lens = np.array([1, 97, 128, S_], np.int32)
    jdt = jnp.bfloat16 if cache_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if cache_dtype == "bf16" else torch.float32
    ref = jfa.flash_attention_decode(
        jnp.asarray(q), jnp.asarray(ring[:, 1, 0], jdt),
        jnp.asarray(ring[:, 1, 1], jdt), jnp.asarray(lens))
    tring = torch.from_numpy(ring).to(tdt)
    k_view, v_view = tring[:, 1, 0], tring[:, 1, 1]
    assert not k_view.is_contiguous()
    out = tfa.flash_attention_decode(torch.from_numpy(q), k_view, v_view,
                                     torch.from_numpy(lens))
    tol = 2e-5 if cache_dtype == "f32" else 2e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_decode_equals_last_row_of_causal_flash():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4))
    full = tfa.flash_attention(q, k, v, causal=True)
    dec = tfa.flash_attention_decode(q[:, :, -1], k.transpose(1, 2),
                                     v.transpose(1, 2),
                                     torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_allclose(dec.numpy(), full[:, :, -1].numpy(),
                               rtol=2e-5, atol=2e-5)
