"""The port's LM building blocks against the reference's, at f32 compute.

Norms, RoPE, the four MLP activations, decode attention over a ring cache,
the RWKV6 token-shift mix, decay, single step and channel mix.  Inputs and
weights come from a numpy seed and go to both frameworks as arrays; every
comparison is at rtol = atol = 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.configs import base
from repro_torch.models import attention, common, mlp, rwkv6

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
