"""The port's dropout: the Philox4x32-10 mask function (``ops/philox.py``),
the attention-dropout branch of the fused flash-attention twins (B1, B2a,
B2b) and of ``xla_attention``, and the fused residual/embedding dropout
twin (B3, ``ops/fused_dropout.py``). The CUDA kernels draw the same masks
(``csrc/philox.cuh``) and are held against these twins on the card by
``tests/test_torch_cuda.py``.

Masks never equal JAX's (ROADMAP, Randomness), so the attention twins are
held against a same-mask oracle written in JAX from the JAX test's
``_oracle`` (``tests/test_fused_attention.py``): dense attention whose
softmax weights are multiplied by the port's dumped keep mask over 1 - p,
differentiated by ``jax.grad``. Tolerances, as max |port - oracle| /
max |oracle|: fp32 1e-5 (the same math in another order), bf16 2e-2 (the
JAX kernel test's bound: P and dS are rounded to 8 bits at other places).
Each bound has a control, the twin run with another seed, that fails it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.ops import fused_dropout as jfd
from building_llm_from_scratch_tpu_torch.ops import attention as tatt
from building_llm_from_scratch_tpu_torch.ops import fused_attention as tfa
from building_llm_from_scratch_tpu_torch.ops import fused_dropout as tfd
from building_llm_from_scratch_tpu_torch.ops import philox
from torch_port_helpers import bits, to_np32

RATE = 0.1


# ---------------------------------------------------------------------------
# the mask function
# ---------------------------------------------------------------------------

# Random123's known-answer vectors of philox4x32_10: counter, key, output
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    words = philox.philox4x32_10(*(torch.tensor([c]) for c in ctr),
                                 key[0] | (key[1] << 32))
    assert tuple(int(w) for w in words) == want


def test_keep_threshold_is_unsigned():
    """keep = bits >= threshold over the whole uint32 range (a signed
    compare keeps 0.4 instead of 0.9 at rate 0.1, as the JAX kernel notes)."""
    assert philox.keep_threshold(0.1) == int(0.1 * 2 ** 32)
    assert philox.keep_threshold(1.0) == 2 ** 32 - 1
    assert philox.keep_threshold(0.0) == 0
    m = philox.flat_keep_mask(3, (4096, 128), 0.1)
    assert abs(m.float().mean().item() - 0.9) < 2e-3


def _causal(T):
    return torch.tril(torch.ones(T, T, dtype=torch.bool))


def test_attention_mask_keep_fraction_and_seeds():
    """Keep fraction over the causal entries within 2e-3 of 1 - p at
    B 2, H 4, T 512; the same seed gives the same mask, the next seed
    another."""
    B, H, T = 2, 4, 512
    m = tfa.keep_mask(11, B, H, T, RATE)
    assert m.shape == (B, H, T, T) and m.dtype == torch.bool
    frac = m[:, :, _causal(T)].float().mean().item()
    assert abs(frac - (1 - RATE)) < 2e-3, frac
    assert torch.equal(m, tfa.keep_mask(11, B, H, T, RATE))
    other = tfa.keep_mask(12, B, H, T, RATE)
    assert 0.1 < (m != other).float().mean().item() < 0.3


@pytest.mark.parametrize("rows", [32, 64])
def test_attention_mask_does_not_depend_on_tiling(rows):
    """The mask recomputed block by block (rows of queries at an offset, as
    a kernel tile sees them, from the element coordinates alone) equals the
    whole mask: keyed on (seed, b, h, q, k), never on a tile."""
    B, H, T, seed = 2, 3, 256, 77
    whole = tfa.keep_mask(seed, B, H, T, RATE)
    thr = philox.keep_threshold(RATE)
    b = torch.arange(B)[:, None, None, None]
    h = torch.arange(H)[None, :, None, None]
    k = torch.arange(T)[None, None, None, :]
    for r0 in range(0, T, rows):
        q = (r0 + torch.arange(rows))[None, None, :, None]
        words = philox.philox4x32_10(k >> 1, q >> 1, h, b, seed)
        pick = 2 * (q & 1) + (k & 1)
        block = torch.stack(words, -1).gather(
            -1, pick.expand(B, H, rows, T)[..., None])[..., 0] >= thr
        assert torch.equal(block, whole[:, :, r0:r0 + rows])


# ---------------------------------------------------------------------------
# attention dropout
# ---------------------------------------------------------------------------

DT = {"fp32": (jnp.float32, torch.float32, 1e-5),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(B, T, Hq, Hkv, D, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, T, Hq, D), f(B, T, Hkv, D), f(B, T, Hkv, D), f(B, T, Hq, D)


def rel(a, b) -> float:
    a, b = to_np32(a), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_oracle(q, k, v, do, mask, rate, jdt):
    """out and (dq, dk, dv) of sum(out * do) for dense attention with the
    keep mask (B, Hq, T, T) applied to the softmax weights (the JAX test's
    ``_oracle``), in the dtype ``jdt``."""
    B, T, Hq, D = q.shape
    G = Hq // k.shape[2]
    keep = jnp.asarray(mask, jnp.float32)

    def attend(q_, k_, v_):
        qh = q_.transpose(0, 2, 1, 3)
        kh = jnp.repeat(k_.transpose(0, 2, 1, 3), G, axis=1)
        vh = jnp.repeat(v_.transpose(0, 2, 1, 3), G, axis=1)
        s = jnp.einsum("bhqd,bhkd->bhqk", qh, kh,
                       preferred_element_type=jnp.float32) / np.sqrt(D)
        s = jnp.where(np.tril(np.ones((T, T), bool)), s, -1e30)
        p = jax.nn.softmax(s, axis=-1) * keep / (1.0 - rate)
        out = jnp.einsum("bhqk,bhkd->bhqd", p.astype(vh.dtype), vh,
                         preferred_element_type=jnp.float32)
        return out.transpose(0, 2, 1, 3).astype(q_.dtype)

    def f(q_, k_, v_):
        out = attend(q_, k_, v_)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do)), out

    args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(*args)
    return np.asarray(out.astype(jnp.float32)), [
        np.asarray(g.astype(jnp.float32)) for g in grads]


def twin(q, k, v, do, tdt, rate, seed):
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    out = tfa.fused_causal_attention(tq, tk, tv, dropout_rate=rate, seed=seed)
    out.float().backward(torch.from_numpy(do))
    return out, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_dropout_twins_match_the_same_mask_oracle(dtype, Hq, Hkv):
    """Forward and autograd gradients of the dropout twins (GQA included)
    against the JAX same-mask oracle; the twin with the next seed fails the
    bound."""
    B, T, D, seed = 2, 256, 64, 1234
    jdt, tdt, tol = DT[dtype]
    q, k, v, do = inputs(B, T, Hq, Hkv, D, seed=Hkv)
    mask = tfa.keep_mask(seed, B, Hq, T, RATE).numpy()
    out_j, grads_j = jax_oracle(q, k, v, do, mask, RATE, jdt)
    out, grads = twin(q, k, v, do, tdt, RATE, seed)
    assert out.dtype == tdt and grads[1].shape == (B, T, Hkv, D)
    errs = [rel(out, out_j)] + [rel(g, gj) for g, gj in zip(grads, grads_j)]
    assert max(errs) <= tol, errs
    out_c, grads_c = twin(q, k, v, do, tdt, RATE, seed + 1)
    control = [rel(out_c, out_j)] + [rel(g, gj) for g, gj in zip(grads_c, grads_j)]
    assert min(control) > tol, control


def test_dropout_rate_zero_is_the_no_dropout_path():
    q, k, v, do = inputs(1, 256, 4, 2, 64, seed=5)
    a = tfa.fused_attention_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    b = tfa.fused_attention_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                      0.0, 99)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    out0, g0 = twin(q, k, v, do, torch.float32, 0.0, None)
    out1, g1 = twin(q, k, v, do, torch.float32, 0.0, 99)
    assert torch.equal(out0, out1)
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))


def test_dropout_is_causal_and_deterministic():
    """Changing the keys and values past position 128 changes nothing
    before it; the same seed gives the same output."""
    q, k, v, _ = (torch.from_numpy(x) for x in inputs(1, 256, 4, 4, 64, seed=6))
    out = tfa.fused_causal_attention(q, k, v, dropout_rate=RATE, seed=3)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:] += 1.0
    v2[:, 128:] -= 1.0
    out2 = tfa.fused_causal_attention(q, k2, v2, dropout_rate=RATE, seed=3)
    assert torch.equal(out[:, :128], out2[:, :128])
    assert not torch.equal(out[:, 128:], out2[:, 128:])
    assert torch.equal(out, tfa.fused_causal_attention(q, k, v, dropout_rate=RATE,
                                                       seed=3))
    with pytest.raises(ValueError, match="seed"):
        tfa.fused_causal_attention(q, k, v, dropout_rate=RATE)


def test_xla_path_draws_the_fused_mask():
    """``xla_attention`` with dropout (the path of short and unaligned
    shapes) draws the same mask as the fused twins: at an eligible shape the
    two agree to fp32 rounding, and the next seed does not."""
    q, k, v, _ = (torch.from_numpy(x) for x in inputs(2, 256, 4, 2, 64, seed=7))
    fused = tfa.fused_causal_attention(q, k, v, dropout_rate=RATE, seed=21)
    xla = tatt.xla_attention(q, k, v, dropout_rate=RATE, seed=21,
                             deterministic=False)
    assert rel(xla, fused) <= 1e-5
    assert rel(tatt.xla_attention(q, k, v, dropout_rate=RATE, seed=22,
                                  deterministic=False), fused) > 1e-2
    assert torch.equal(tatt.xla_attention(q, k, v, dropout_rate=RATE, seed=21),
                       tatt.xla_attention(q, k, v))   # deterministic by default


# ---------------------------------------------------------------------------
# B3: fused residual / embedding dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_dropout_twin_arithmetic(dtype):
    """p = 0 is the identity; kept elements are h * (1/(1-p)) rounded to
    the dtype (the Pallas arithmetic), dropped ones 0; the keep fraction is
    within 2e-3 of 1 - p; dropout_add is x + dropout(h) in the dtype."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(64, 8, 128, generator=g).to(dtype)
    x = torch.randn(64, 8, 128, generator=g).to(dtype)
    assert torch.equal(tfd.fused_dropout(h, 0.0, 5), h)
    out = tfd.fused_dropout(h, RATE, 5)
    keep = philox.flat_keep_mask(5, h.shape, RATE)
    inv = torch.tensor(1.0 / (1.0 - RATE), dtype=torch.float64).to(dtype)
    assert torch.equal(out[keep], (h * inv)[keep])
    assert not out[~keep].any()
    assert abs(keep.float().mean().item() - (1 - RATE)) < 2e-3
    if dtype == torch.bfloat16:    # the Pallas math, not x / (1 - p)
        assert inv.item() == 1.109375
        assert not torch.equal(out[keep], (h / (1 - RATE)).to(dtype)[keep])
    np.testing.assert_array_equal(bits(tfd.fused_dropout_add(x, h, RATE, 5)),
                                  bits(x + out))


def test_fused_dropout_backward_regenerates_the_mask():
    """dh of a ones cotangent is the forward's mask times 1/(1-p); the
    backward of dropout_add passes g to x unchanged."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(16, 256, generator=g).requires_grad_(True)
    h = torch.randn(16, 256, generator=g).requires_grad_(True)
    out = tfd.fused_dropout_add(x, h, RATE, 9)
    cot = torch.randn(16, 256, generator=g)
    out.backward(cot)
    assert torch.equal(x.grad, cot)
    keep = philox.flat_keep_mask(9, h.shape, RATE)
    h1 = h.detach().clone().requires_grad_(True)
    tfd.fused_dropout(h1, RATE, 9).backward(torch.ones(16, 256))
    assert torch.equal(h1.grad, keep.float() * tfd.inv_keep(RATE, torch.float32))
    assert torch.equal(h.grad, torch.where(keep, cot * h1.grad, 0.0))
    fwd_keep = tfd.fused_dropout(torch.ones(16, 256), RATE, 9) != 0
    assert torch.equal(fwd_keep, keep)


@pytest.mark.parametrize("shape", [(8, 1024, 768), (997, 128), (1, 3, 128),
                                   (8, 100), (4, 64, 128)])
def test_fused_dropout_route_is_the_jax_supports_shape(shape):
    assert tfd.supports_shape(shape) == jfd.supports_shape(shape)
