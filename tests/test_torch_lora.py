"""LoRA in the port (``models/lora.py``, kernel B6's twin, the adapter
arguments of the slot functions) against the JAX package on the same
inputs:

  - B6's twin ``lora_bgmv_plain`` against the JAX ``lora_bgmv`` in
    interpret mode on the JAX test's case (S 5, N 3, D 128, r 8, O 256,
    ids [0, -1, 2, 1, 2]), fp32 and bf16, and against float64 numpy; at a
    shape the TPU gate refuses (D 96, O 200, r 4) against numpy only;
  - ``apply_lora``, ``lora_delta`` and ``merge_lora`` against JAX's with a
    scalar and a per-row scale;
  - artifacts readable both ways bit for bit (fp32 and bf16), the same
    fingerprint for every config, ``lora_from_jax`` bit-exact;
  - the five slot functions with a pool of three adapters and ids mixed
    across adapters and -1: fp32 logits within 1e-5 and caches within 1e-6
    of JAX's; one bf16 decode tick within a stated bound that permuted ids
    fail.

Bounds of B6 are per output element, relative to M = scale * (|x @ A| @
|B|) in float64 (the magnitude of the second product's terms): fp32 sums
in another order, 1e-5 M; in bf16 the rank-r intermediate is rounded to
bf16 (half a unit, 2^-9), each side from its own fp32 sum, so 2^-7 M
between two implementations and 2^-8 M against the exact result. A row with
id -1 has M = 0 and must be exactly 0.

The CUDA kernel itself is tested on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu import configs as jcfgs
from building_llm_from_scratch_tpu.models import lora as jlora
from building_llm_from_scratch_tpu.models import transformer as jtf
from building_llm_from_scratch_tpu.ops.decode_step import (
    lora_bgmv as jax_bgmv,
    supports_lora_shape as jax_supports_lora_shape,
)
from building_llm_from_scratch_tpu.serving.adapters import AdapterRegistry as JReg
from building_llm_from_scratch_tpu.serving.kvcache import (
    KVCachePolicy as JPolicy,
)
from building_llm_from_scratch_tpu_torch import configs as tcfgs
from building_llm_from_scratch_tpu_torch.models import lora as tlora
from building_llm_from_scratch_tpu_torch.models import transformer as ttf
from building_llm_from_scratch_tpu_torch.ops import decode_step as tds
from building_llm_from_scratch_tpu_torch.serving.adapters import AdapterRegistry
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    lora_from_jax,
    params_from_jax,
)
from torch_port_helpers import (
    bits,
    jax_params,
    make_jax_lora,
    small_configs,
    to_np32,
)

TOL = {"fp32": (1e-5, 1e-5), "bf16": (2.0 ** -7, 2.0 ** -8)}


# ---------------------------------------------------------------------------
# B6's twin
# ---------------------------------------------------------------------------

def bgmv_case(S=5, N=3, D=128, r=8, O=256, ids=(0, -1, 2, 1, 2)):
    """The JAX test's ``_bgmv_case`` (tests/test_lora_serving.py)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((S, D)).astype(np.float32)
    A = rng.standard_normal((N, D, r)).astype(np.float32)
    B = rng.standard_normal((N, r, O)).astype(np.float32)
    scales = rng.uniform(0.25, 2.0, N).astype(np.float32)
    return x, A, B, np.asarray(ids, np.int32), scales


def exact_and_magnitude(x, A, B, ids, scales):
    """float64 numpy: (exact B6 result, the magnitude M of the bounds)."""
    idx = np.clip(ids, 0, A.shape[0] - 1)
    xa = np.einsum("sd,sdr->sr", x.astype(np.float64), A[idx].astype(np.float64))
    keep = np.where(ids >= 0, scales[idx], 0.0)[:, None]
    Bs = B[idx].astype(np.float64)
    return (np.einsum("sr,sro->so", xa, Bs) * keep,
            np.einsum("sr,sro->so", np.abs(xa), np.abs(Bs)) * keep)


def within(out, ref, mag, tol) -> bool:
    return bool((np.abs(np.asarray(out, np.float64) - ref) <= tol * mag).all())


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_b6_twin_matches_jax_and_numpy(dt):
    x, A, B, ids, sc = bgmv_case()
    dtype = tcfgs.DTYPE_MAP[dt]
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    tx, tA, tB = t(x), t(A), t(B)
    before = tds.lora_bgmv.launches
    out = tds.lora_bgmv(tx, tA, tB, torch.from_numpy(ids), torch.from_numpy(sc))
    assert tds.lora_bgmv.launches == before          # CPU: the twin
    assert out.dtype == torch.float32 and tuple(out.shape) == (5, 256)
    assert not out[1].any()                           # id -1: exactly 0
    jd = jnp.float32 if dt == "fp32" else jnp.bfloat16
    ref = np.asarray(jax_bgmv(jnp.asarray(x, jd), jnp.asarray(A, jd),
                              jnp.asarray(B, jd), jnp.asarray(ids),
                              jnp.asarray(sc), interpret=True))
    exact, mag = exact_and_magnitude(to_np32(tx), to_np32(tA), to_np32(tB),
                                     ids, sc)
    t_impl, t_exact = TOL[dt]
    assert within(out.numpy(), ref.astype(np.float64), mag, t_impl)
    assert within(out.numpy(), exact, mag, t_exact)
    # the bound catches a row served by the wrong adapter
    perm = ids[[1, 2, 3, 4, 0]]
    wrong = tds.lora_bgmv_plain(tx, tA, tB, torch.from_numpy(perm),
                                torch.from_numpy(sc))
    assert not within(wrong.numpy(), exact, mag, t_impl)


def test_b6_twin_at_a_shape_the_tpu_gate_refuses():
    """The port's kernel takes any widths: its twin at D 96, O 200, r 4
    (refused by the TPU gate) against numpy, and an id past the pool
    clamps to the last row."""
    x, A, B, ids, sc = bgmv_case(S=4, N=3, D=96, r=4, O=200, ids=(2, -1, 0, 5))
    assert not jax_supports_lora_shape(96, 4, 200)
    t = torch.from_numpy
    out = tds.lora_bgmv(t(x), t(A), t(B), t(ids), t(sc))
    exact, mag = exact_and_magnitude(x, A, B, ids, sc)
    assert within(out.numpy(), exact, mag, 1e-5)
    assert not out[1].any()
    assert torch.equal(out[3], tds.lora_bgmv(t(x[3:]), t(A), t(B),
                                             t(np.array([2], np.int32)), t(sc))[0])


def test_lora_shape_gates():
    for D, r, O in [(768, 8, 768), (768, 16, 3072), (100, 8, 768),
                    (768, 8, 50257), (768, 4, 768), (2048, 256, 512),
                    (2048, 264, 512)]:
        assert tds.supports_lora_shape(D, r, O) == jax_supports_lora_shape(D, r, O)
    for r in (1, 16, 256):
        for dt in (torch.float32, torch.float16, torch.bfloat16):
            tds.check_lora_kernel_shape(r, dt)
    for r, dt in ((0, torch.float32), (257, torch.bfloat16), (8, torch.float64)):
        with pytest.raises(ValueError, match="BGMV kernel"):
            tds.check_lora_kernel_shape(r, dt)


def test_b6_wrapper_rejects():
    x = torch.zeros(3, 16)
    A, B = torch.zeros(2, 16, 4), torch.zeros(2, 4, 8)
    ids, sc = torch.zeros(3, dtype=torch.int32), torch.ones(2)
    for args in ((x[:, :8], A, B, ids, sc),                  # D
                 (x, A, torch.zeros(2, 3, 8), ids, sc),       # rank
                 (x, A, B, ids[:2], sc),                      # rows
                 (x, A, B, ids, torch.ones(3)),               # pool rows
                 (x.double(), A, B, ids, sc),                 # dtype
                 (x[0], A, B, ids, sc)):                      # rank of x
        with pytest.raises((ValueError, TypeError)):
            tds.lora_bgmv(*args)


# ---------------------------------------------------------------------------
# LoRA math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
def test_apply_lora_and_lora_delta_match_jax(per_row):
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, w = f(2, 3, 16), f(16, 24)
    if per_row:
        a, b, s = f(2, 16, 4), f(2, 4, 24), np.array([0.0, 2.0], np.float32)
    else:
        a, b, s = f(16, 4), f(4, 24), np.float32(2.0)
    t = torch.from_numpy
    node, jnode = {"A": t(a), "B": t(b)}, {"A": jnp.asarray(a), "B": jnp.asarray(b)}
    got = tlora.apply_lora(t(x), t(w), node, t(np.asarray(s)))
    want = jlora.apply_lora(jnp.asarray(x), jnp.asarray(w), jnode, jnp.asarray(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    d = tlora.lora_delta(t(x), node, t(np.asarray(s)))
    jd = jlora.lora_delta(jnp.asarray(x), jnode, jnp.asarray(s))
    assert d.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=1e-5)
    # no node: exactly the base product; a per-row scale 0: exactly base
    assert torch.equal(tlora.apply_lora(t(x), t(w), None), t(x) @ t(w))
    if per_row:
        assert torch.equal(got[0], (t(x) @ t(w))[0])


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_init_merge_and_count_match_jax(kind):
    jcfg, tcfg = small_configs(kind)
    params, np_params = jax_params(jcfg)
    jl = make_jax_lora(jcfg, params, 3, 4)
    tl = lora_from_jax(jax.device_get(jl), tcfg, "cpu")
    base = params_from_jax(np_params, tcfg, "cpu").flat_params()
    merged = tlora.merge_lora(base, tl, 8.0, 4)
    jmerged = jax.device_get(jlora.merge_lora(params, jl, 8.0, 4))
    changed = {k for k in merged if not torch.equal(merged[k], base[k])}
    assert changed == {"/".join(p[:-1]) for p in tlora.flatten_lora(tl)}
    for name, leaf in merged.items():
        node = jmerged
        for part in name.split("/"):
            node = node[part]
        np.testing.assert_allclose(leaf.numpy(), np.asarray(node), atol=1e-6,
                                   rtol=1e-6)
    # the port's init: the JAX tree's paths and shapes, B zero, A bounded
    init = tlora.init_lora_params(tcfg, torch.Generator().manual_seed(0), 4)
    jinit = jlora.init_lora_params(jcfg, params, jax.random.PRNGKey(0), rank=4)
    flat = tlora.flatten_lora(init)
    jflat = {tuple(p.key for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jinit)[0]}
    assert list(flat) == list(jflat)
    for path, leaf in flat.items():
        assert tuple(leaf.shape) == jflat[path].shape
        if path[-1] == "B":
            assert not leaf.any()
        else:
            assert leaf.abs().max() <= 1.0 / np.sqrt(leaf.shape[-2])
    assert tlora.count_lora_params(init) == jlora.count_lora_params(jinit)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_artifacts_read_both_ways_bit_for_bit(dt, tmp_path):
    jcfg, tcfg = small_configs("llama", dtype=dt)
    params, _ = jax_params(jcfg)
    jl = make_jax_lora(jcfg, params, 5, 4)
    jpath = str(tmp_path / "jax.npz")
    jlora.save_adapter(jpath, jl, rank=4, alpha=8.0, cfg=jcfg)
    tl, meta = tlora.load_adapter(jpath)
    jflat = {".".join(p.key for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jax.device_get(jl))[0]}
    tflat = {".".join(p): leaf for p, leaf in tlora.flatten_lora(tl).items()}
    assert list(tflat) == list(jflat)
    for key, leaf in tflat.items():
        assert leaf.dtype == tcfg.torch_dtype
        np.testing.assert_array_equal(bits(leaf), bits(jflat[key]))
    assert meta == {"format": 1, "rank": 4, "alpha": 8.0,
                    "fingerprint": tlora.adapter_fingerprint(tcfg),
                    "model": tcfg.name}
    # the port's file, read by JAX
    tpath = str(tmp_path / "port.npz")
    tlora.save_adapter(tpath, tl, rank=4, alpha=8.0, cfg=tcfg)
    back, jmeta = jlora.load_adapter(tpath)
    assert jmeta == meta
    bflat = {".".join(p.key for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(back)[0]}
    assert list(bflat) == list(jflat)
    for key, leaf in bflat.items():
        assert leaf.dtype == jflat[key].dtype
        np.testing.assert_array_equal(bits(leaf), bits(jflat[key]))
    assert set(np.load(tpath).files) == set(np.load(jpath).files)


def test_fingerprint_matches_jax_for_every_config():
    n = 0
    for model, sizes in jcfgs.MODEL_PARAMS_MAPPING.items():
        assert tcfgs.MODEL_PARAMS_MAPPING[model] == sizes
        for size in sizes:
            jcfg = jcfgs.get_config(model, size)
            tcfg = tcfgs.get_config(model, size)
            assert tlora.adapter_fingerprint(tcfg) == \
                jlora.adapter_fingerprint(jcfg), (model, size)
            n += 1
    assert n >= 9


def test_load_refuses_non_adapter_and_newer_format(tmp_path):
    path = str(tmp_path / "not_adapter.npz")
    np.savez(path, foo=np.zeros(3))
    with pytest.raises(ValueError, match="not an adapter artifact"):
        tlora.load_adapter(path)
    newer = str(tmp_path / "newer.npz")
    np.savez(newer, __adapter_meta__=np.asarray(
        '{"format": 2, "rank": 4, "alpha": 8.0, "fingerprint": "x"}'))
    with pytest.raises(ValueError, match="newer"):
        tlora.load_adapter(newer)


def test_lora_from_jax_is_bit_exact_and_checks_shapes():
    jcfg, tcfg = small_configs("gpt2", dtype="bf16")
    params, _ = jax_params(jcfg)
    jl = jax.device_get(make_jax_lora(jcfg, params, 6, 8))
    tl = lora_from_jax(jl, tcfg, "cpu")
    jflat = {tuple(p.key for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jl)[0]}
    for path, leaf in tlora.flatten_lora(tl).items():
        np.testing.assert_array_equal(bits(leaf), bits(jflat[path]))
    flat = {"/".join(p): v for p, v in jflat.items()}
    lora_from_jax(flat, tcfg, "cpu")                 # the flat form
    del flat["head/weight/B"]
    with pytest.raises(KeyError, match="missing"):
        lora_from_jax(flat, tcfg, "cpu")
    _, other = small_configs("gpt2", dtype="bf16", emb_dim=64)
    with pytest.raises(ValueError, match="shape"):
        lora_from_jax(jl, other, "cpu")


# ---------------------------------------------------------------------------
# slot functions against JAX, with a pool of three adapters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["gpt2", "llama"])
def pools(request, tmp_path_factory):
    """Both packages' models and registries (adapters a, b, c of ranks 4,
    8 and 2 in rows 0-2, one spare row) from the same weights and the same
    artifact files."""
    jcfg, tcfg = small_configs(request.param)
    params, np_params = jax_params(jcfg, seed=4)
    d = tmp_path_factory.mktemp(f"pools-{request.param}")
    specs = {}
    for i, (name, rank) in enumerate([("a", 4), ("b", 8), ("c", 2)]):
        specs[name] = str(d / f"{name}.npz")
        jlora.save_adapter(specs[name], make_jax_lora(jcfg, params, 10 + i, rank),
                           rank=rank, alpha=2.0 * rank, cfg=jcfg)
    jreg = JReg.from_artifacts(jcfg, params, specs, capacity=4)
    treg = AdapterRegistry.from_artifacts(tcfg, specs, capacity=4, device="cpu")
    return (jcfg, params, jreg, params_from_jax(np_params, tcfg, "cpu"), treg)


def adapters(jreg, treg, ids):
    pool, scaling = jreg.pool_args()
    tpool, tscaling = treg.pool_args()
    ids = np.asarray(ids, np.int32)
    return ({"pool": pool, "scaling": scaling, "ids": jnp.asarray(ids)},
            {"pool": tpool, "scaling": tscaling, "ids": torch.from_numpy(ids)})


def random_caches(jcfg, tcfg, n_rows, length, policy=None, tpolicy=None, seed=0):
    """The same random (garbage) cache state in both packages."""
    jc = jtf.init_slot_cache(jcfg, n_rows, length, policy=policy)
    rng = np.random.default_rng(seed)
    jc = {k: [jnp.asarray(rng.standard_normal(b.shape).astype(np.float32),
                          b.dtype) for b in v] for k, v in jc.items()}
    tc = {k: [torch.from_numpy(np.array(b, np.float32)).to(tcfg.torch_dtype)
              for b in v] for k, v in jc.items()}
    return jc, tc


def assert_caches_close(tc, jc, atol=1e-6):
    for name in ("k", "v"):
        for a, b in zip(tc[name], jc[name]):
            np.testing.assert_allclose(to_np32(a), np.asarray(b, np.float32),
                                       atol=atol, rtol=0)


@pytest.mark.parametrize("row", [0, 1, 2, -1])
def test_prefill_into_slot_with_adapter_matches_jax(pools, row):
    jcfg, params, jreg, model, treg = pools
    ja, ta = adapters(jreg, treg, [row])
    jc, tc = random_caches(jcfg, model.cfg, 2, 64)
    tokens = np.random.default_rng(row + 5).integers(0, 512, (1, 16))
    jl, jnew = jtf.prefill_into_slot(params, jcfg, jnp.asarray(tokens, jnp.int32),
                                     jnp.int32(11), jnp.int32(1), jc, adapter=ja)
    tl = ttf.prefill_into_slot(model, torch.from_numpy(tokens), 11, 1, tc,
                               adapter=ta)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert_caches_close(tc, jnew)
    if row == -1:       # id -1 is the base model, bit for bit
        base = ttf.prefill_into_slot(model, torch.from_numpy(tokens), 11, 1,
                                     random_caches(jcfg, model.cfg, 2, 64)[1])
        assert torch.equal(tl, base)


def test_chunked_prefill_with_adapter_matches_jax(pools):
    jcfg, params, jreg, model, treg = pools
    ja, ta = adapters(jreg, treg, [1])
    jc, tc = random_caches(jcfg, model.cfg, 2, 64)
    prompt = np.random.default_rng(9).integers(0, 512, 21)
    for lo in range(0, 21, 8):
        chunk = np.zeros((1, 8), np.int64)
        chunk[0, :len(prompt[lo:lo + 8])] = prompt[lo:lo + 8]
        jl, jnew = jtf.prefill_chunk_into_slot(
            params, jcfg, jnp.asarray(chunk, jnp.int32), jnp.int32(lo),
            jnp.int32(21), jnp.int32(0), jc, adapter=ja)
        jc = {k: list(v) for k, v in jnew.items()}
        tl = ttf.prefill_chunk_into_slot(model, torch.from_numpy(chunk), lo, 21,
                                         0, tc, adapter=ta)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert_caches_close(tc, jc)


def test_decode_slots_with_adapters_matches_jax(pools):
    """Rows of three adapters and the base model in one tick: B6's twin on
    the block projections, the gathered head."""
    jcfg, params, jreg, model, treg = pools
    ja, ta = adapters(jreg, treg, [0, -1, 2, 1])
    jc, tc = random_caches(jcfg, model.cfg, 4, 64)
    toks = np.array([[5], [17], [300], [2]], np.int64)
    lens = np.array([3, 40, 0, 63], np.int32)
    jl, jnew = jtf.decode_slots(params, jcfg, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(lens), jc, adapter=ja)
    tl = ttf.decode_slots(model, torch.from_numpy(toks), torch.from_numpy(lens),
                          tc, adapter=ta)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert_caches_close(tc, jnew)


def test_paged_slot_functions_with_adapters_match_jax(pools):
    jcfg, params, jreg, model, treg = pools
    pol = dict(paged=True, page_tokens=8, prefill_chunk=16)
    jc, tc = random_caches(jcfg, model.cfg, 3, 64, policy=JPolicy(**pol),
                           seed=2)
    table = np.array([[3, 4, 0, 0, 0, 0, 0, 0], [5, 6, 7, 0, 0, 0, 0, 0],
                      [1, 2, 0, 0, 0, 0, 0, 0]], np.int32)
    prompt = np.random.default_rng(3).integers(0, 512, (1, 16))
    ja, ta = adapters(jreg, treg, [2])
    jl, jnew = jtf.paged_prefill_chunk_into_slot(
        params, jcfg, jnp.asarray(prompt, jnp.int32), jnp.int32(0),
        jnp.int32(13), jnp.int32(1), jnp.asarray(table), jc, adapter=ja,
        cache_len=64)
    tl = ttf.paged_prefill_chunk_into_slot(
        model, torch.from_numpy(prompt), 0, 13, torch.from_numpy(table[1:2]), tc,
        64, adapter=ta)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert_caches_close(tc, jnew)
    jc = {k: list(v) for k, v in jnew.items()}
    ja, ta = adapters(jreg, treg, [-1, 2, 0])
    toks = np.array([[7], [9], [11]], np.int64)
    lens = np.array([12, 13, 5], np.int32)
    jl, jnew = jtf.paged_decode_slots(
        params, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(lens),
        jnp.asarray(table), jc, adapter=ja, cache_len=64)
    tl = ttf.paged_decode_slots(model, torch.from_numpy(toks),
                                torch.from_numpy(lens), torch.from_numpy(table),
                                tc, 64, adapter=ta)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert_caches_close(tc, jnew)


def test_bf16_decode_tick_within_bound_and_permuted_ids_fail(tmp_path):
    """bf16: the port's tick (B6's twin, which rounds x @ A) against JAX's
    (the gathered path, which rounds (x @ A) @ B): logits within a cosine
    of 0.9995 and 0.1 rms of JAX's (chip_smoke's bf16 serving bound); the
    same tick with the rows' adapters permuted must fail it."""
    jcfg, tcfg = small_configs("llama", dtype="bf16")
    params, np_params = jax_params(jcfg, seed=4)
    specs = {}
    for i, (name, rank) in enumerate([("a", 4), ("b", 8)]):
        specs[name] = str(tmp_path / f"{name}.npz")
        jlora.save_adapter(specs[name], make_jax_lora(jcfg, params, 10 + i, rank),
                           rank=rank, alpha=2.0 * rank, cfg=jcfg)
    jreg = JReg.from_artifacts(jcfg, params, specs)
    treg = AdapterRegistry.from_artifacts(tcfg, specs, device="cpu")
    model = params_from_jax(np_params, tcfg, "cpu")
    toks = np.array([[5], [17], [300], [2]], np.int64)
    lens = np.array([3, 40, 9, 63], np.int32)
    ids = [0, 1, -1, 0]
    jc, tc = random_caches(jcfg, tcfg, 4, 64)
    ja, _ = adapters(jreg, treg, ids)
    jl, _ = jtf.decode_slots(params, jcfg, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(lens), jc, adapter=ja)
    jl = np.asarray(jl, np.float64)

    def port(row_ids):
        cache = {k: [b.clone() for b in v] for k, v in tc.items()}
        _, ta = adapters(jreg, treg, row_ids)
        return ttf.decode_slots(model, torch.from_numpy(toks),
                                torch.from_numpy(lens), cache,
                                adapter=ta).double().numpy()

    def agree(a, b):
        cos = min(np.dot(x, y) / np.linalg.norm(x) / np.linalg.norm(y)
                  for x, y in zip(a, b))
        rms = np.sqrt((b ** 2).mean(axis=-1)).min()
        return cos >= 0.9995 and np.abs(a - b).max() <= 0.1 * rms

    assert agree(port(ids), jl)
    assert not agree(port([1, 0, -1, 1]), jl)
