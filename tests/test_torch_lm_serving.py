"""LM serving parity of the PyTorch port against the JAX package, on the
CPU, through the public entry points ``make_prefill_step`` and
``make_serve_step`` of both (bfloat16 compute, the served step):

* prefill logits, and four decode steps against a fresh decode state,
  of the ten archs (dense, vlm, audio, ssm, moe, hybrid) at their
  ``reduced()`` size
  with the JAX weights (``params_from_jax``), within 0.1: the two
  frameworks round bf16 at other places.  The bar is set from readings
  (``python tests/test_torch_lm_serving.py`` prints them): above the
  largest sound difference over four weight and token seeds, and below
  the smallest one of a port whose causal mask drops the diagonal key.
  A bf16 rounding fault moves the logits no more than the two
  frameworks' own rounding does; the float32 parity tests hold those;
* the port's own prefill against its token-by-token decode, within the
  reference's 0.15 (tests/test_lm_smoke.py), and a Mamba (Falcon's
  Mamba-1, zamba2's Mamba-2 with its shared block's K/V) prefill state
  that continues into decode;
* reduced Nemotron-4 at its own head dim, 192 (the Hopper forward's
  112-key tiles on the card), against JAX: prefill and decode logits
  within 0.1, and the float32 ``forward_hidden`` within 1e-5;
* ``_cast_compute`` is the identity on a cast tree, and the entry points
  put their state on the card unless asked for the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import lm_zoo as JZ
from repro.models import transformer_lm as JT
from repro_torch.configs import get_arch
from repro_torch.models import lm_zoo as TZ
from repro_torch.models import transformer_lm as TT
from repro_torch.models.convert import params_from_jax

BF16_TOL = 0.1
DECODE_TOL = 0.15          # the reference's prefill-vs-decode bar
ARCHS = ["qwen3-14b", "yi-6b", "granite-3-8b", "nemotron-4-340b",
         "chameleon-34b", "hubert-xlarge", "falcon-mamba-7b",
         "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "zamba2-2.7b"]


@functools.lru_cache(maxsize=None)
def _params(arch, seed=1):
    cfg = j_get_arch(arch).reduced()
    jp = JZ.init_params(cfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_arch(arch).reduced(), jp, tp


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)}
    return {"frames": rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32)}


def _diff(got, want):
    return float(np.abs(got.numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_match_jax(arch):
    jcfg, tcfg, jp, tp = _params(arch)
    B, S = 2, 12
    batch = _batch(jcfg, B, S, seed=len(arch))
    l_j, st_j = JZ.make_prefill_step(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    l_t, st_t = TZ.make_prefill_step(tcfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert l_t.dtype == torch.float32 and tuple(l_t.shape) == l_j.shape
    assert _diff(l_t, l_j) <= BF16_TOL
    if jcfg.is_encoder:
        assert st_t is None and st_j is None
        l_e, _ = TZ.make_serve_step(tcfg)(
            tp, None, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert torch.equal(l_e, l_t)
        return
    assert st_t["pos"].tolist() == [S] * B
    ds_j = JT.init_decode_state(jcfg, B, S)
    ds_t = TT.init_decode_state(tcfg, B, S, device="cpu")
    serve_j, serve_t = JZ.make_serve_step(jcfg), TZ.make_serve_step(tcfg)
    for i in range(4):
        tok = batch["tokens"][:, i:i + 1]
        l_j, ds_j = serve_j(jp, ds_j, jnp.asarray(tok))
        l_t, ds_t = serve_t(tp, ds_t, torch.from_numpy(tok))
        assert _diff(l_t, l_j) <= BF16_TOL, f"decode step {i}"
    assert ds_t["pos"].tolist() == [4] * B


def _served_diff(arch, seed=1, batch_seed=None):
    """Largest |port - JAX| over the prefill logits and four decode steps
    of a fresh decode state."""
    jcfg, tcfg, jp, tp = _params(arch, seed)
    B, S = 2, 12
    batch = _batch(jcfg, B, S, len(arch) if batch_seed is None
                   else batch_seed)
    l_j, _ = JZ.make_prefill_step(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    l_t, _ = TZ.make_prefill_step(tcfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    diff = _diff(l_t, l_j)
    if jcfg.is_encoder:
        return diff
    ds_j = JT.init_decode_state(jcfg, B, S)
    ds_t = TT.init_decode_state(tcfg, B, S, device="cpu")
    serve_j, serve_t = JZ.make_serve_step(jcfg), TZ.make_serve_step(tcfg)
    for i in range(4):
        tok = batch["tokens"][:, i:i + 1]
        l_j, ds_j = serve_j(jp, ds_j, jnp.asarray(tok))
        l_t, ds_t = serve_t(tp, ds_t, torch.from_numpy(tok))
        diff = max(diff, _diff(l_t, l_j))
    return diff


def _ref_without_the_diagonal(q, k, v, *, causal):
    """flash_attention_ref with a fault: a causal row other than the first
    does not see its own key."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    Sq, Skv = q.shape[1], k.shape[1]
    if not causal or Sq == 1:
        return flash_attention_ref(q, k, v, causal=causal)
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * D ** -0.5
    kpos = torch.arange(Skv)[None]
    qpos = (torch.arange(Sq) + Skv - Sq)[:, None]
    s = s.masked_fill((kpos > qpos) | ((kpos == qpos) & (qpos > 0)),
                      float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


@pytest.mark.parametrize("arch", ["yi-6b", "granite-3-8b"])
def test_bf16_bar_catches_a_causal_mask_fault(arch, monkeypatch):
    """The served-logits bar fails a port whose causal mask drops the
    diagonal key (granite-3-8b has the smallest logits)."""
    from repro_torch.kernels.flash_attention import ops
    monkeypatch.setattr(ops, "flash_attention_ref",
                        _ref_without_the_diagonal)
    assert _served_diff(arch) > BF16_TOL


@pytest.mark.parametrize("arch", ["yi-6b", "falcon-mamba-7b",
                                  "qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e", "zamba2-2.7b"])
def test_prefill_matches_token_by_token_decode(arch):
    """A moe prefill that dropped slots would differ by design: the
    length is one at which it drops none, and that is checked (top 1 of
    4 experts has capacity 4 a row: at S 8 it drops, at S 4 it cannot)."""
    _, cfg, _, tp = _params(arch)
    B, S = 2, 4 if arch == "llama4-scout-17b-a16e" else 8
    toks = torch.from_numpy(_batch(cfg, B, S, seed=0)["tokens"])
    logits_p, _ = TZ.make_prefill_step(cfg)(tp, {"tokens": toks})
    if cfg.moe is not None:
        x = TZ._cast_compute(tp)["embed"][toks.long()]
        _, aux, _ = TT.forward_hidden(cfg, TZ._cast_compute(tp), x,
                                      torch.arange(S)[None].expand(B, S))
        assert float(aux["moe_drop_frac"]) == 0.0
    ds = TT.init_decode_state(cfg, B, S, device="cpu")
    serve = TZ.make_serve_step(cfg)
    for i in range(S):
        logits_d, ds = serve(tp, ds, toks[:, i:i + 1])
    assert float((logits_p - logits_d).abs().max()) <= DECODE_TOL


def _one_longer(state, jnp_pad=False):
    """A prefill state with room for one more token: its K/V stacks (L,
    B, S, Hkv, Dh) padded to S + 1 (a prefill's are exactly S long)."""
    if "k" not in state:
        return state
    if jnp_pad:
        pad = lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
    else:
        pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1))
    return dict(state, k=pad(state["k"]), v=pad(state["v"]))


def test_mamba_prefill_state_continues_into_decode():
    _state_continues("falcon-mamba-7b")


def test_hybrid_prefill_state_continues_into_decode():
    _state_continues("zamba2-2.7b")


def _state_continues(arch):
    """prefill(S) then one decode step of token S == the last logits of
    prefill(S + 1), in the port and against JAX's continuation."""
    jcfg, cfg, jp, tp = _params(arch)
    B, S = 2, 9
    toks = _batch(cfg, B, S + 1, seed=3)["tokens"]
    prefill, serve = TZ.make_prefill_step(cfg), TZ.make_serve_step(cfg)
    _, st = prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    l_next, st = serve(tp, _one_longer(st), torch.from_numpy(toks[:, S:]))
    l_full, _ = prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert float((l_next - l_full).abs().max()) <= DECODE_TOL
    assert st["pos"].tolist() == [S + 1] * B
    _, st_j = JZ.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(
        toks[:, :S])})
    l_j, _ = JZ.make_serve_step(jcfg)(jp, _one_longer(st_j, True),
                                      jnp.asarray(toks[:, S:]))
    assert _diff(l_next, l_j) <= BF16_TOL


@functools.lru_cache(maxsize=None)
def _nemotron_192(seed=1):
    """Reduced Nemotron-4 with its full-size head dim, 192, on both
    sides (the reduced config's is 16)."""
    jcfg = dataclasses.replace(j_get_arch("nemotron-4-340b").reduced(),
                               head_dim=192)
    tcfg = dataclasses.replace(get_arch("nemotron-4-340b").reduced(),
                               head_dim=192)
    jp = JZ.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_nemotron_head_dim_192_prefill_and_decode_match_jax():
    jcfg, tcfg, jp, tp = _nemotron_192()
    assert tcfg.head_dim_ == 192 and jcfg.head_dim == 192
    B, S = 2, 12
    batch = _batch(jcfg, B, S, seed=192)
    l_j, _ = JZ.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(batch["tokens"])})
    l_t, st_t = TZ.make_prefill_step(tcfg)(
        tp, {"tokens": torch.from_numpy(batch["tokens"])})
    assert tuple(st_t["k"].shape[-2:]) == (tcfg.n_kv_heads, 192)
    assert _diff(l_t, l_j) <= BF16_TOL
    ds_j = JT.init_decode_state(jcfg, B, S)
    ds_t = TT.init_decode_state(tcfg, B, S, device="cpu")
    serve_j, serve_t = JZ.make_serve_step(jcfg), TZ.make_serve_step(tcfg)
    for i in range(4):
        tok = batch["tokens"][:, i:i + 1]
        l_j, ds_j = serve_j(jp, ds_j, jnp.asarray(tok))
        l_t, ds_t = serve_t(tp, ds_t, torch.from_numpy(tok))
        assert _diff(l_t, l_j) <= BF16_TOL, f"decode step {i}"


def test_nemotron_head_dim_192_float32_hidden_matches_jax():
    """The float32 path (no cast): within one float32 op's 1e-5."""
    jcfg, tcfg, jp, tp = _nemotron_192()
    B, S = 2, 11
    rng = np.random.default_rng(192)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    h_j = JT.forward_hidden(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))[0]
    h_t = TT.forward_hidden(tcfg, tp, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()))[0]
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j, np.float32),
                               rtol=1e-5, atol=1e-5)


def test_cast_compute_is_identity_on_a_cast_tree():
    _, cfg, _, tp = _params("falcon-mamba-7b")
    cp = TZ._cast_compute(tp)
    m = cp["layers"]["mamba1"]
    assert m["in_proj"].dtype == torch.bfloat16
    for name in ("A_log", "dt_bias", "D"):
        assert m[name].dtype == torch.float32
        assert m[name] is tp["layers"]["mamba1"][name]
    again = TZ._cast_compute(cp)
    assert again["embed"] is cp["embed"]
    assert again["layers"]["mamba1"]["in_proj"] is m["in_proj"]


def test_entry_points_default_to_the_card():
    cfg = get_arch("yi-6b").reduced()
    if torch.cuda.is_available():
        st = TT.init_decode_state(cfg, 1, 4)
        assert st["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.init_decode_state(cfg, 1, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TZ.init_params(cfg, torch.Generator())
    st = TT.init_decode_state(cfg, 1, 4, device="cpu")
    assert st["k"].shape == (cfg.n_layers, 1, 4, cfg.n_kv_heads,
                             cfg.head_dim_)


if __name__ == "__main__":
    # The readings behind BF16_TOL: sound runs over four seeds, then the
    # causal-mask fault.
    from repro_torch.kernels.flash_attention import ops
    for arch in ARCHS:
        print("sound", arch, [round(_served_diff(arch, w, b), 4)
                              for w, b in ((1, None), (2, 5), (3, 7),
                                           (4, 11))], flush=True)
    ops.flash_attention_ref = _ref_without_the_diagonal
    for arch in ARCHS[:5]:
        print("diagonal key dropped", arch, round(_served_diff(arch), 4),
              flush=True)
