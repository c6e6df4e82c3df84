"""The port's LM building blocks against the reference's, at f32 compute.

Norms, RoPE, the four MLP activations, decode attention over a ring cache,
the RWKV6 token-shift mix, decay, single step and channel mix, the Griffin
block's causal conv, RG-LRU scan and step, and the MoE layer's capacity,
routing (the keep mask of dropped tokens), output and aux loss.  Inputs and
weights come from a numpy seed and go to both frameworks as arrays; every
comparison is at rtol = atol = 1e-5.
"""
import torch_threads  # noqa: F401  (first: one OpenMP thread, set before torch loads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import griffin as ref_griffin
from repro.models import mlp as ref_mlp
from repro.models import moe as ref_moe
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.configs import base
from repro_torch.models import attention, common, griffin, mlp, moe, rwkv6

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor)
                                          else got),
                               np.asarray(want, np.float32), rtol=TOL, atol=TOL)


def _t(a):
    return torch.as_tensor(np.array(a))


def _cfgs(arch, **changes):
    """(reference cfg, port cfg): the reduced config at f32 compute."""
    changes = {"compute_dtype": "float32", **changes}
    return (dataclasses.replace(ref_base.get_reduced_config(arch), **changes),
            dataclasses.replace(base.get_reduced_config(arch), **changes))


def test_configs_are_the_references():
    for arch in ref_base.arch_ids():
        assert dataclasses.asdict(base.get_config(arch)) == \
            dataclasses.asdict(ref_base.get_config(arch))
        assert dataclasses.asdict(base.get_reduced_config(arch)) == \
            dataclasses.asdict(ref_base.get_reduced_config(arch))
    assert base.arch_ids() == ref_base.arch_ids()


def test_rmsnorm_and_layernorm():
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    _close(common.rmsnorm(_t(x), _t(scale)), ref_common.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    _close(common.layernorm(_t(x), _t(scale), _t(bias)),
           ref_common.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(theta):
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 900, (2, 7)).astype(np.int32)
    _close(common.apply_rope(_t(x), _t(pos), theta),
           ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_activations(act):
    rcfg, cfg = _cfgs("llama3.2-1b", mlp_act=act)
    rng = _rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("wi", (cfg.d_model, cfg.d_ff)), ("wg", (cfg.d_model, cfg.d_ff)),
                      ("wo", (cfg.d_ff, cfg.d_model)))}
    if act in ("gelu", "relu2"):
        del p["wg"]
    _close(mlp.apply_mlp(cfg, {k: _t(v) for k, v in p.items()}, _t(x)),
           ref_mlp.apply_mlp(rcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


def _attn_params(cfg, rng):
    d, H, K, h = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in (("wq", (d, H, h)), ("wk", (d, K, h)), ("wv", (d, K, h)),
                         ("wo", (H, h, d)))}


@pytest.mark.parametrize("kind", ["attn", "local"])
def test_attend_decode_ring_cache(kind):
    """Eight decode steps over a 4-slot ring (local) or a linear cache,
    lanes at different depths; the cache and the outputs every step."""
    rcfg, cfg = _cfgs("llama3.2-1b", window=4)
    rng = _rng(3)
    p = _attn_params(cfg, rng)
    max_seq = 16
    rspec = ref_attention.cache_spec(rcfg, kind, max_seq)
    spec = attention.cache_spec(cfg, kind, max_seq)
    assert (spec.length, spec.ring) == (rspec.length, rspec.ring)
    assert spec.ring == (kind == "local")
    rcache = ref_attention.init_kv_cache(rcfg, rspec, 2, jnp.float32)
    cache = attention.init_kv_cache(cfg, spec, 2, torch.float32, "cpu")
    pos = np.array([0, 3], np.int32)
    for _ in range(8):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        ry, rcache = ref_attention.attend_decode(
            rcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), rcache, kind,
            jnp.asarray(pos), rspec)
        y, cache = attention.attend_decode(cfg, {k: _t(v) for k, v in p.items()}, _t(x),
                                           cache, kind, _t(pos), spec)
        _close(y, ry)
        for leaf in ("k", "v", "pos"):
            _close(cache[leaf], rcache[leaf])
        pos = pos + 1


def test_masks():
    for S, T, off in ((5, 5, 0), (3, 8, 5)):
        assert np.array_equal(attention._causal_mask(S, T, "cpu", off).numpy(),
                              np.asarray(ref_attention._causal_mask(S, T, off)))
        assert np.array_equal(attention._window_mask(S, T, 3, "cpu", off).numpy(),
                              np.asarray(ref_attention._window_mask(S, T, 3, off)))


def _rwkv_params(cfg, rng):
    d, hd, f = cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff
    R, L = rwkv6.DDLERP_RANK, rwkv6.LORA_RANK
    shapes = {"mu_x": (d,), "mu": (5, d), "ddl_w1": (d, 5 * R), "ddl_w2": (5, R, d),
              "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d),
              "decay_base": (d,), "decay_w1": (d, L), "decay_w2": (L, d),
              "bonus_u": (d // hd, hd), "gn_scale": (d,), "gn_bias": (d,),
              "cm_mu_k": (d,), "cm_mu_r": (d,), "cm_wk": (d, f), "cm_wv": (f, d),
              "cm_wr": (d, d)}
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32) for k, s in shapes.items()}
    p["decay_base"] -= 4.0
    return p


@pytest.fixture
def rwkv_setup():
    rcfg, cfg = _cfgs("rwkv6-7b")
    rng = _rng(4)
    p = _rwkv_params(cfg, rng)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    return (rcfg, cfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()}, x, last, rng)


def test_ddlerp_and_decay(rwkv_setup):
    rcfg, cfg, rp, p, x, last, _ = rwkv_setup
    xprev = rwkv6._shift(_t(x), _t(last))
    rxprev = ref_rwkv6._shift(jnp.asarray(x), jnp.asarray(last))
    _close(xprev, rxprev)
    got = rwkv6._ddlerp(p, _t(x), xprev)
    want = ref_rwkv6._ddlerp(rp, jnp.asarray(x), rxprev)
    for g, w in zip(got, want):
        _close(g, w)
    _close(rwkv6._decay(p, got[3]), ref_rwkv6._decay(rp, want[3]))


def test_wkv_step(rwkv_setup):
    *_, rng = rwkv_setup
    B, H, h = 2, 3, 8
    r, k, v = (rng.standard_normal((B, H, h)).astype(np.float32) for _ in range(3))
    logw = -rng.uniform(0.02, 2.0, (B, H, h)).astype(np.float32)
    u = rng.standard_normal((H, h)).astype(np.float32)
    s = rng.standard_normal((B, H, h, h)).astype(np.float32)
    got = rwkv6.wkv_step(*(_t(a) for a in (r, k, v, logw, u, s)))
    want = ref_rwkv6.wkv_step(*(jnp.asarray(a) for a in (r, k, v, logw, u, s)))
    for g, w in zip(got, want):
        _close(g, w)


def test_channel_mix(rwkv_setup):
    rcfg, cfg, rp, p, x, last, _ = rwkv_setup
    got, got_last = rwkv6.channel_mix(cfg, p, _t(x), _t(last))
    want, want_last = ref_rwkv6.channel_mix(rcfg, rp, jnp.asarray(x), jnp.asarray(last))
    _close(got, want)
    _close(got_last, want_last)


@pytest.mark.parametrize("S", [1, 6])
def test_time_mix_from_the_zero_state(rwkv_setup, S):
    """One token runs ``wkv_step``, several run K7's plain version."""
    rcfg, cfg, rp, p, x, _, _ = rwkv_setup
    got = rwkv6.time_mix(cfg, p, _t(x[:, :S]), chunk=4)
    want = ref_rwkv6.time_mix(rcfg, rp, jnp.asarray(x[:, :S]), chunk=4)
    for g, w in zip(got, want):
        _close(g, w)


def test_time_mix_refuses_a_carried_state_over_several_tokens(rwkv_setup):
    """Several tokens from a carried state (a chunked prefill) run K7's
    plain version from that state, and agree with the reference's
    ``time_mix(state=s)`` at 1e-4: S 6 (chunks of 3 by the reference's chunk
    rule) and S 5 (prime: chunks of 1), the state that the first tokens of
    the same sequence leave."""
    rcfg, cfg, rp, p, x, last, _ = rwkv_setup
    _, s, lx = ref_rwkv6.time_mix(rcfg, rp, jnp.asarray(x[:, :3]), None,
                                  jnp.asarray(last), chunk=4)
    assert float(jnp.abs(s).max()) > 0.1
    for S in (6, 5):
        xs = np.concatenate([x[:, 3:], x[:, :S - 3]], axis=1)
        got = rwkv6.time_mix(cfg, p, _t(xs), _t(s), _t(lx), chunk=4)
        want = ref_rwkv6.time_mix(rcfg, rp, jnp.asarray(xs), s, lx, chunk=4)
        for g, w in zip(got, want):
            _close(g, w)


def test_time_mix_in_two_pieces_is_the_whole(rwkv_setup):
    """A prefill of 6 tokens equals 3 tokens, then 3 more from the state
    and last token the first 3 leave."""
    _, cfg, _, p, x, last, _ = rwkv_setup
    whole, s_whole, _ = rwkv6.time_mix(cfg, p, _t(x), None, _t(last), chunk=4)
    o1, s1, l1 = rwkv6.time_mix(cfg, p, _t(x[:, :3]), None, _t(last), chunk=4)
    o2, s2, _ = rwkv6.time_mix(cfg, p, _t(x[:, 3:]), s1, l1, chunk=4)
    torch.testing.assert_close(torch.cat([o1, o2], 1), whole, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s2, s_whole, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Griffin (RG-LRU) block
# ---------------------------------------------------------------------------
def _griffin_params(cfg, rng):
    d, rw, W = cfg.d_model, cfg.lru_width, cfg.conv1d_width
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, rw)), ("w_rec", (d, rw)), ("conv_w", (W, rw)),
                      ("w_a", (rw, rw)), ("w_x", (rw, rw)), ("w_out", (rw, d)))}
    for k in ("conv_b", "b_a", "b_x"):
        p[k] = (rng.standard_normal(rw) * 0.1).astype(np.float32)
    a = np.linspace(0.9, 0.999, rw, dtype=np.float32)
    p["lam"] = np.log(np.expm1(-np.log(a) / 8.0)).astype(np.float32)
    return p


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv1d(with_tail):
    rng = _rng(5)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    tail = rng.standard_normal((2, 3, 16)).astype(np.float32) if with_tail else None
    y, t = griffin.causal_conv1d(_t(x), _t(w), _t(b), None if tail is None else _t(tail))
    ry, rt = ref_griffin.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       None if tail is None else jnp.asarray(tail))
    _close(y, ry)
    _close(t, rt)


def _lru_inputs(rng, B, S, rw):
    xi = rng.standard_normal((B, S, rw)).astype(np.float32)
    r = 1 / (1 + np.exp(-rng.standard_normal((B, S, rw)))).astype(np.float32)
    i = 1 / (1 + np.exp(-rng.standard_normal((B, S, rw)))).astype(np.float32)
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, rw)) / 8.0)).astype(np.float32)
    log_a_base = (-8.0 * np.logaddexp(lam, 0)).astype(np.float32)
    return xi, r.astype(np.float32), i.astype(np.float32), log_a_base


@pytest.mark.parametrize("S", [1, 2, 37, 128])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan(S, with_h0):
    """The doubling scan against ``jax.lax.associative_scan``: two sum
    orders of decays <= 1, within 1e-5 (the worst found: 2.1e-6, at S 128
    from h0, |h| up to 2.3)."""
    rng = _rng(6 + S)
    xi, r, i, lab = _lru_inputs(rng, 2, S, 24)
    h0 = rng.standard_normal((2, 24)).astype(np.float32) if with_h0 else None
    h, last = griffin.rg_lru(_t(xi), _t(r), _t(i), _t(lab), None if h0 is None else _t(h0))
    rh, rlast = ref_griffin.rg_lru(jnp.asarray(xi), jnp.asarray(r), jnp.asarray(i),
                                   jnp.asarray(lab), None if h0 is None else jnp.asarray(h0))
    _close(h, rh)
    _close(last, rlast)


def test_rg_lru_step():
    rng = _rng(7)
    xi, r, i, lab = _lru_inputs(rng, 3, 1, 24)
    h = rng.standard_normal((3, 24)).astype(np.float32)
    got = griffin.rg_lru_step(_t(xi[:, 0]), _t(r[:, 0]), _t(i[:, 0]), _t(lab), _t(h))
    want = ref_griffin.rg_lru_step(jnp.asarray(xi[:, 0]), jnp.asarray(r[:, 0]),
                                   jnp.asarray(i[:, 0]), jnp.asarray(lab), jnp.asarray(h))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("S,carried", [(9, False), (9, True), (1, True)])
def test_griffin_block(S, carried):
    """A prefill from the zero state and from a carried (h, conv) state,
    and a decode step (one token and a state: ``rg_lru_step``)."""
    rcfg, cfg = _cfgs("recurrentgemma-9b")
    rng = _rng(8)
    p = _griffin_params(cfg, rng)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    state = None
    if carried:
        state = {"h": rng.standard_normal((2, cfg.lru_width)).astype(np.float32),
                 "conv": rng.standard_normal((2, cfg.conv1d_width - 1, cfg.lru_width))
                 .astype(np.float32)}
    y, st = griffin.griffin_block(cfg, {k: _t(v) for k, v in p.items()}, _t(x),
                                  None if state is None else {k: _t(v) for k, v in state.items()})
    ry, rst = ref_griffin.griffin_block(
        rcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        None if state is None else {k: jnp.asarray(v) for k, v in state.items()})
    _close(y, ry)
    for k in ("h", "conv"):
        _close(st[k], rst[k])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def test_capacity():
    _, cfg = _cfgs("qwen2-moe-a2.7b")
    rcfg = ref_base.get_config("qwen2-moe-a2.7b")
    full = base.get_config("qwen2-moe-a2.7b")
    for c, rc in ((cfg, ref_base.get_reduced_config("qwen2-moe-a2.7b")), (full, rcfg)):
        for n in (1, 5, 16, 100, 509, 1024):
            for f in (0.25, 1.0, 1.25, 2.0):
                assert moe.capacity(c, n, f) == ref_moe.capacity(rc, n, f), (n, f)
    assert moe.capacity(full, 509) == 48 and moe.capacity(full, 1) == 8


def _moe_params(cfg, rng):
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "wi": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wg": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    if m.d_ff_shared:
        fs = m.d_ff_shared
        p["shared"] = {"wi": rng.standard_normal((d, fs)) / np.sqrt(d),
                       "wg": rng.standard_normal((d, fs)) / np.sqrt(d),
                       "wo": rng.standard_normal((fs, d)) / np.sqrt(fs)}
        p["shared_gate"] = rng.standard_normal((d, 1)) / np.sqrt(d)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _ref_keep(rcfg, rp, x, C):
    """The reference's keep mask (``moe.py:66-77``, which it does not
    return): top-k of the f32 router, each choice's slot in the flattened
    (S·k) order, kept below C."""
    m = rcfg.moe
    B, S, _ = x.shape
    probs = jax.nn.softmax(x.astype(jnp.float32) @ rp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    flat = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.float32).reshape(B, S * m.top_k, -1)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    return np.asarray(pos.reshape(B, S, m.top_k).astype(jnp.int32) < C)


@pytest.mark.parametrize("arch,factor,group", [("qwen2-moe-a2.7b", 1.25, 4096),
                                               ("qwen2-moe-a2.7b", 0.25, 4096),
                                               ("mixtral-8x7b", 0.25, 4096),
                                               ("mixtral-8x7b", 0.25, 12)])
def test_apply_moe(arch, factor, group):
    """Output, aux loss and keep mask, with shared experts (Qwen2-MoE) and
    without (Mixtral); at factor 0.25 the 8 slots an expert drop tokens,
    and with groups of 12 each of the 2 groups a row has its own slots."""
    rcfg, cfg = _cfgs(arch)
    rng = _rng(9)
    p = _moe_params(cfg, rng)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pt = jax.tree.map(_t, p)
    rp = jax.tree.map(jnp.asarray, p)
    out, aux = moe.apply_moe(cfg, pt, _t(x), factor, group)
    rout, raux = ref_moe.apply_moe(rcfg, rp, jnp.asarray(x), factor, group)
    _close(out, rout)
    _close(aux, raux)
    S = min(group, x.shape[1])
    xs = x.reshape(-1, S, cfg.d_model)
    C = moe.capacity(cfg, S, factor)
    keep = moe.route(cfg, pt, _t(xs), C)["keep"].numpy()
    want = _ref_keep(rcfg, rp, jnp.asarray(xs), C)
    assert np.array_equal(keep, want)
    assert keep.all() == (factor == 1.25)
