"""Moonlight-16B-A3B (the DeepSeek-V3 layout of ``port_configs``) against
the benchmark's plain reference (``bench/reference/moe.py``) and against
its own parts' plain versions: the port's training step at small widths
through the benchmark's own comparison (``bench.drivers.train``,
``bench.check``), in float32 (rounding alone) and in bf16; the sigmoid
routing with its selection bias; the dropless dispatch and combine; the
shared experts; the plain attention at a query/key head dim of 192 and a
value head dim of 128; the published parameter count; the configuration
file against the program's tree; the spans and counters; the launcher.
Tests marked ``cuda`` hold K3a/K3b at (192, 128) and the dropless layer on
K6/K6b to their plain versions on the card, and skip elsewhere."""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import check, flops_moe  # noqa: E402
from bench.drivers import train as bench_train  # noqa: E402
from bench.reference import moe as ref_moe  # noqa: E402
from repro_torch import port_configs  # noqa: E402
from repro_torch.config import Family, ModelConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm_plain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.port_configs import MOONLIGHT  # noqa: E402

CONFIG = ROOT / "bench" / "configs" / "moonlight-16b-a3b.json"
CPU = torch.device("cpu")


def _file() -> dict:
    return json.loads(CONFIG.read_text())


# the base widths cut (the preset's MLA widths, shared experts and dense
# layer stay as published: a plain ModelConfig can carry only the base)
SMALL = {"hidden_size": 128, "num_attention_heads": 2,
         "num_key_value_heads": 2, "num_hidden_layers": 3,
         "vocab_size": 512, "n_routed_experts": 8, "num_experts_per_tok": 3,
         "moe_intermediate_size": 64, "eos_token_id": 1}
SMALL_PORT = {"d_model": 128, "n_heads": 2, "n_kv_heads": 2, "n_layers": 3,
              "vocab_size": 512, "n_experts": 8, "top_k": 3, "d_ff": 64}


def small_config(compute_dtype: str) -> dict:
    cfg = _file()
    cfg.update(SMALL)
    cfg["port_config"] = dict(cfg["port_config"], **SMALL_PORT,
                              compute_dtype=compute_dtype)
    return cfg


def small_mix() -> dict:
    mix = json.loads((ROOT / "bench" / "traffic" / "train_4k.json")
                     .read_text())
    mix.update(seq_len=64, shard_tokens=20000)
    mix["documents"] = dict(mix["documents"], median=16, max=256)
    return mix


def _readings(compute_dtype: str, seed: int, prec: str = "f32") -> dict:
    cfg, mix = small_config(compute_dtype), small_mix()
    p = bench_train.prepare(cfg, mix, seed, CPU)
    p.close()
    ref, differ = bench_train.reference(p.model, cfg, p.layout, seed, CPU,
                                        mix["optimizer"], p.shard,
                                        p.loader.kept, prec)
    return check.readings(p.prog, ref, differ)


# ------------------------------------------------ against the reference ----

def test_the_port_follows_the_reference_in_float32():
    """Loss, every leaf's first gradient and the change of one AdamW step
    (two checked steps) in float32 compute: rounding alone."""
    r = _readings("float32", 2 ** 31 + 9)
    assert r["loss"] < 1e-5
    assert r["grad"] < 1e-4
    assert r["change"] < 1e-4
    assert r["rows"] == 0
    assert r["_leaves"]["quiet"] == ["blocks/moe/e_score_correction_bias"]


# bf16 compute against the f32 reference, over two seeds: the program
# rounds every product's operands and the residual stream to bf16, and its
# router reads the bf16 normed input, so a token whose 6th and 7th choices
# lie closer than that rounding takes another expert (each flip moves that
# token's output by a gate's share). Read on the CPU: loss 0.0078, grad
# 0.0059, change 0.0012; the float8 control read 0.023, 0.028, 0.0036. The
# limits sit at about twice the bf16 readings, under the control's.
BF16_LIMITS = {"loss": 0.016, "grad": 0.012, "change": 0.0025}


@pytest.mark.parametrize("seed", [2 ** 31 + 9, 2 ** 32 + 5])
def test_the_port_follows_the_reference_in_bf16(seed):
    r = _readings("bfloat16", seed)
    for k, limit in BF16_LIMITS.items():
        assert r[k] < limit, (k, r[k])
    assert r["rows"] == 0


def test_the_float8_control_fails_the_bf16_limits():
    """The reference in float8 put in the program's place fails at least
    one limit: the limits tell a lower precision apart."""
    cfg, mix = small_config("bfloat16"), small_mix()
    seed = 2 ** 31 + 9
    p = bench_train.prepare(cfg, mix, seed, CPU)
    p.close()
    args = (p.model, cfg, p.layout, seed, CPU, mix["optimizer"], p.shard,
            p.loader.kept)
    ref, _ = bench_train.reference(*args, "f32")
    control, _ = bench_train.reference(*args, "fp8")
    r = check.readings(control, ref, 0)
    assert any(r[k] >= limit for k, limit in BF16_LIMITS.items()), r


# ---------------------------------------------------------- configuration --

def test_the_published_parameter_count():
    assert MOONLIGHT.param_count() == 15_960_110_208
    assert flops_moe.param_count(dict(_file(), num_hidden_layers=27)) == \
        15_960_110_208
    assert flops_moe.param_count(_file()) == 3_093_455_616
    # 6 of 64 routed experts: "A3B"
    assert MOONLIGHT.active_param_count() == 2_914_776_192


def test_the_configuration_file_resolves_to_the_preset_at_its_depth():
    """What the benchmark's driver builds from ``port_config`` (a plain
    ModelConfig) is the preset cut to 5 layers, and its tree on ``meta`` is
    the reference's layout, leaf for leaf."""
    cfg = _file()
    pc = dict(cfg["port_config"], family=Family(cfg["port_config"]["family"]))
    got = port_configs.resolve(ModelConfig(**pc))
    assert got == dataclasses.replace(MOONLIGHT, n_layers=5)
    assert got.param_count() == flops_moe.param_count(cfg)
    meta = bench_train._paths(transformer.init(got, device="meta",
                                               master=True))
    want = {p: tuple(s) for p, s, _, _ in ref_moe.layout(cfg)}
    assert {p: tuple(t.shape) for p, t in meta.items()} == want
    for key, value in {"hidden_size": got.d_model, "kv_lora_rank":
                       got.kv_lora_rank, "qk_nope_head_dim":
                       got.qk_nope_head_dim, "qk_rope_head_dim":
                       got.qk_rope_head_dim, "v_head_dim": got.v_head_dim,
                       "n_routed_experts": got.n_experts,
                       "num_experts_per_tok": got.top_k,
                       "n_shared_experts": got.n_shared_experts,
                       "first_k_dense_replace": got.first_k_dense,
                       "intermediate_size": got.dense_d_ff,
                       "moe_intermediate_size": got.d_ff,
                       "routed_scaling_factor": got.routed_scaling,
                       "rms_norm_eps": got.rms_eps,
                       "rope_theta": got.rope_theta}.items():
        assert cfg[key] == value, key


def test_the_launchers_find_the_preset():
    assert port_configs.get_config("moonlight-16b-a3b") is MOONLIGHT
    assert port_configs.arch_ids()[-1] == "moonlight-16b-a3b"
    assert "moonlight-16b-a3b" not in \
        __import__("repro_torch.configs", fromlist=["x"]).all_arch_ids()


# ---------------------------------------------------------------- routing --

def _router(D=16, E=8, K=3, scaling=2.446):
    cfg = dataclasses.replace(MOONLIGHT.reduced(), n_experts=E, top_k=K,
                              routed_scaling=scaling)
    g = torch.Generator().manual_seed(3)
    mp = {"router": torch.randn(D, E, generator=g),
          "e_score_correction_bias": torch.zeros(E)}
    return cfg, mp, torch.randn(32, D, generator=g)


def test_selection_by_score_plus_bias_weights_by_score():
    cfg, mp, x = _router()
    s = torch.sigmoid(x @ mp["router"])
    # a bias that puts expert 3 first for every token, whatever its score
    mp["e_score_correction_bias"][3] = 5.0
    gates, idx = MOE.route_sigmoid(mp, cfg, x)
    assert (idx[:, 0] == 3).all()
    chosen = s.gather(-1, idx)
    want = chosen / chosen.sum(-1, keepdim=True) * 2.446
    torch.testing.assert_close(gates, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(gates.sum(-1), torch.full((32,), 2.446),
                               rtol=1e-6, atol=0)


def test_selection_ties_go_to_the_lower_index():
    cfg, mp, x = _router()
    mp["router"] = torch.zeros_like(mp["router"])    # every score 0.5
    gates, idx = MOE.route_sigmoid(mp, cfg, x)
    assert (idx == torch.arange(3)).all()
    torch.testing.assert_close(gates, torch.full((32, 3), 2.446 / 3))


def test_the_selection_bias_gets_no_gradient_and_adamw_leaves_it():
    cfg = MOONLIGHT.reduced()
    from repro_torch.config import TrainConfig
    from repro_torch.train.steps import make_train_step
    params = transformer.init(cfg, seed=1, device="cpu", master=True)
    bias = params["blocks"]["moe"]["e_score_correction_bias"]
    before = bias.clone()
    step, opt = make_train_step(cfg, TrainConfig(microbatches=2))
    state = opt.init(params)
    tok = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(0))
    params, state, _ = step(params, state, {"tokens": tok, "labels": tok})
    assert torch.equal(params["blocks"]["moe"]["e_score_correction_bias"],
                       before)
    assert not state.m["blocks"]["moe"]["e_score_correction_bias"].any()
    assert state.m["blocks"]["moe"]["router"].abs().sum() > 0
    # the step marks the bias frozen, and every other leaf as trained
    assert not bias.requires_grad
    assert params["blocks"]["moe"]["router"].requires_grad


@pytest.mark.parametrize("route", ["update", "update_plain"])
def test_adamw_skips_a_frozen_leaf_and_raises_on_a_missing_gradient(route):
    """A leaf without a gradient is left as it is where its parameter
    requires none; where it requires one (a parameter cut off from the
    loss) the update raises."""
    from repro_torch.optim import AdamW
    opt = AdamW(lr=0.1)
    params = {"a": torch.ones(4), "frozen": torch.ones(3)}
    state = opt.init(params)
    grads = {"a": torch.full((4,), 0.5), "frozen": None}
    params, state, _ = getattr(opt, route)(grads, state, params)
    assert torch.equal(params["frozen"], torch.ones(3))
    assert (params["a"] < 1).all()
    params["frozen"].requires_grad_(True)
    with pytest.raises(ValueError, match="requires a gradient"):
        getattr(opt, route)({"a": torch.full((4,), 0.5), "frozen": None},
                            state, params)


def test_get_api_and_the_train_step_take_the_preset_for_a_plain_config():
    """A plain ModelConfig naming the preset (what a configuration file
    gives) is taken as the preset where it enters: ``get_api``'s functions
    and ``make_train_step``; the models see the preset's class only."""
    from repro_torch.config import TrainConfig
    from repro_torch.models import registry
    from repro_torch.models.registry import get_api
    from repro_torch.train.steps import make_train_step
    small = MOONLIGHT.reduced()
    plain = ModelConfig(**{f.name: getattr(small, f.name)
                           for f in dataclasses.fields(ModelConfig)})
    full = port_configs.resolve(plain)
    assert full == dataclasses.replace(MOONLIGHT, **{
        f.name: getattr(plain, f.name)
        for f in dataclasses.fields(ModelConfig)})
    api = get_api(plain)
    params = api.init(plain, seed=1, device="cpu", master=True)
    assert "dense_blocks" in params and \
        api.param_axes(plain).keys() == params.keys()
    assert get_api(small) is registry._BY_FAMILY[Family.MOE]
    step, opt = make_train_step(plain, TrainConfig(microbatches=1))
    tok = torch.randint(0, full.vocab_size, (1, 16),
                        generator=torch.Generator().manual_seed(0))
    _, _, metrics = step(params, opt.init(params),
                         {"tokens": tok, "labels": tok})
    assert math.isfinite(float(metrics["loss"]))


# ----------------------------------------------------- dispatch, combine --

def test_the_table_has_one_size_whatever_the_routing():
    x = torch.randn(40, 32)
    sizes = set()
    for idx in (torch.arange(40 * 3).view(40, 3) % 8,
                torch.zeros(40, 3, dtype=torch.long) + torch.arange(3)):
        table, tiles, slot, routed = ops.moe_dispatch(x, idx, n_experts=8,
                                                      tile_m=16)
        sizes.add(table.shape)
        assert table.shape[0] == ops.dispatch_rows(120, 8, 16) == 240
        # every (token, choice) row holds its token; the rest are zeros
        torch.testing.assert_close(table[slot], x.repeat_interleave(3, 0))
        mask = torch.ones(table.shape[0], dtype=torch.bool)
        mask[slot] = False
        assert not table[mask].any()
        # each row's tile belongs to the row's expert
        assert (tiles.long()[slot // 16] == idx.reshape(-1)).all()
        assert routed.sum() == 120
        assert (tiles[(routed.gt(0).sum()):] <= 8).all()
    assert len(sizes) == 1


def test_combine_gives_the_same_bits_twice_and_its_gradient():
    g = torch.Generator().manual_seed(1)
    rows = torch.randn(64, 16, generator=g, dtype=torch.float64)
    slot = torch.randperm(64, generator=g)[:30]
    gates = torch.rand(10, 3, generator=g, dtype=torch.float64)
    out = ops.moe_combine(rows.float(), slot, gates.float())
    assert torch.equal(out, ops.moe_combine(rows.float(), slot,
                                            gates.float()))
    rows.requires_grad_(True)
    gates.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda r, w: ops.moe_combine(r, slot, w), (rows, gates))
    x = torch.randn(10, 16, dtype=torch.float64, requires_grad=True)
    idx = torch.randint(0, 4, (10, 3), generator=g)
    assert torch.autograd.gradcheck(
        lambda x: ops.moe_dispatch(x, idx, n_experts=4, tile_m=8)[0], (x,))


def _layer(cfg, seed=0, skew=None):
    pb = __import__("repro_torch.models.module",
                    fromlist=["x"]).ParamBuilder(seed, lambda p:
                                                 torch.float32, "cpu")
    MOE.init_moe_dropless(pb, cfg)
    p = pb.params
    if skew is not None:
        p["moe"]["e_score_correction_bias"] = skew
    return p


def _reference_layer(p, cfg, x):
    """bench/reference/moe.py's experts on the normed input (ln = 1)."""
    q = {"router": p["moe"]["router"], "bias": p["moe"]
         ["e_score_correction_bias"], "wi": p["moe"]["wi"],
         "wo": p["moe"]["wo"], "ln_mlp": torch.ones(cfg.d_model),
         "shared_wi_gate": p["shared"]["wi_gate"],
         "shared_wi_up": p["shared"]["wi_up"], "shared_wo": p["shared"]["wo"]}
    rc = {"moe_intermediate_size": cfg.d_ff, "num_experts_per_tok":
          cfg.top_k, "norm_topk_prob": True, "routed_scaling_factor":
          cfg.routed_scaling, "n_routed_experts": cfg.n_experts,
          "rms_norm_eps": cfg.rms_eps}
    return ref_moe.experts(q, x, rc, "f32")


def test_a_skewed_router_drops_nothing():
    """A bias that sends every token to the same 3 of 8 experts: GShard's
    capacity of 1.25 would drop most assignments; here every (token,
    choice) is computed and the layer is the reference's."""
    cfg = MOONLIGHT.reduced()
    skew = torch.zeros(cfg.n_experts)
    skew[[1, 4, 6]] = 10.0
    p = _layer(cfg, skew=skew)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    h = L.rmsnorm(x, torch.ones(cfg.d_model), cfg.rms_eps)
    capacity = MOE._capacity(cfg, 128)
    assert capacity < 128           # each chosen expert gets all 128 tokens
    MOE.ROUTED.reset()
    got = MOE.moe_mlp_dropless(p, cfg, h, gmm=gmm_plain)
    torch.testing.assert_close(got, _reference_layer(p, cfg, x),
                               rtol=1e-5, atol=1e-5)
    routed = torch.tensor(MOE.ROUTED.read()[0])
    assert routed[[1, 4, 6]].tolist() == [128] * 3 and routed.sum() == 384


def test_the_shared_experts_count_once():
    cfg = MOONLIGHT.reduced()
    p = _layer(cfg, seed=2)
    p["moe"]["wo"] = torch.zeros_like(p["moe"]["wo"])   # routed part 0
    x = torch.randn(1, 16, cfg.d_model)
    got = MOE.moe_mlp_dropless(p, cfg, x)
    torch.testing.assert_close(got, L.mlp(p["shared"], x), rtol=0, atol=0)


# ------------------------------------------------------- attention plain --

def _naive(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    S = s.shape[-1]
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                      float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def test_plain_attention_at_192_and_128_is_a_plain_softmax():
    g = torch.Generator().manual_seed(7)
    q, k = (torch.randn(2, 48, 3, 192, generator=g, dtype=torch.float64)
            for _ in range(2))
    v, do = (torch.randn(2, 48, 3, 128, generator=g, dtype=torch.float64)
             for _ in range(2))
    o, lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                          causal=True)
    assert o.shape == (2, 48, 3, 128)
    torch.testing.assert_close(o.double(), _naive(q, k, v), rtol=0,
                               atol=1e-5)
    for t in (q, k, v):
        t.requires_grad_(True)
    _naive(q, k, v).backward(do)
    got = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o,
                                       lse, do.float(), causal=True)
    for a, t in zip(got, (q, k, v)):
        torch.testing.assert_close(a.double(), t.grad, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["f32", "grouped", "other_pair"])
def test_the_wrappers_refuse_pairs_the_kernels_do_not_take(case):
    q = torch.zeros(1, 128, 4, 192, dtype=torch.bfloat16)
    k = torch.zeros(1, 128, 4, 192, dtype=torch.bfloat16)
    v = torch.zeros(1, 128, 4, 128, dtype=torch.bfloat16)
    if case == "f32":
        q, k, v = q.float(), k.float(), v.float()
    elif case == "grouped":
        k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    else:
        v = torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa._check(q, k, v, True, (q, k, v))
    fa._check(*(t.bfloat16() for t in (torch.zeros(1, 128, 4, 192),
                                       torch.zeros(1, 128, 4, 192),
                                       torch.zeros(1, 128, 4, 128))),
              True, ())


# ---------------------------------------------------- spans and counters --

def test_the_moe_spans_nest_in_forward_and_backward(gsys_torch):
    from repro_torch.config import TrainConfig
    from repro_torch.data.pipeline import GenesysDataLoader, write_token_shard
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import make_train_step
    import numpy as np
    import tempfile
    cfg = dataclasses.replace(MOONLIGHT.reduced(), remat="full")
    params = transformer.init(cfg, seed=0, device="cpu", master=True)
    step, opt = make_train_step(cfg, TrainConfig(microbatches=2))
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/tok.bin"
        write_token_shard(path, np.random.default_rng(0).integers(
            0, cfg.vocab_size, 8192).astype(np.uint32))
        loader = GenesysDataLoader(gsys_torch, [path], batch=2, seq=32,
                                   seed=0)
        tr = Trainer(gsys_torch, step, params, opt.init(params), loader)
        before = ops.moe_dispatch.launches
        tr.run(1)
        loader.close()
    spans = tr.spans.closed()
    by_id = {s["id"]: s for s in spans}
    moe = [s for s in spans if s["name"] in ("moe_dispatch", "moe_combine")]
    parents = sorted({by_id[s["parent"]]["name"] for s in moe})
    assert parents == ["backward", "forward"]
    # one MoE layer, 2 microbatches, forward and recomputation
    assert ops.moe_dispatch.launches - before == 4
    assert sum(s["name"] == "moe_dispatch" for s in moe) == 4


@pytest.fixture()
def gsys_torch():
    from repro_torch.core.genesys import Genesys, GenesysConfig
    g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                              coalesce_max=8))
    yield g
    g.shutdown()


# ---------------------------------------------------------------- card ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _within(got, want, r=2.0 ** -6, frob=1e-2):
    """K3's rule (``chip_smoke.fa_reading``): every element within r (|want|
    + its vector's rms + the tensor's rms / 16), and the relative Frobenius
    error under ``frob``."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rms_vec = w.square().mean(dim=-1, keepdim=True).sqrt()
    bound = r * (w.abs() + rms_vec + w.square().mean().sqrt() / 16)
    assert (diff / bound).max().item() <= 1.0
    assert (diff.norm() / w.norm()).item() <= frob


@pytest.mark.cuda
@pytest.mark.parametrize("S", [4096, 1000])
def test_k3_at_192_and_128_on_the_card(S):
    """K3a/K3b in bf16 at the cell's shape (B 1, H 16) and at a ragged S,
    against the plain versions; the backward twice gives the same bits."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    q, k = (torch.randn(1, S, 16, 192, generator=g, device=dev)
            .bfloat16() for _ in range(2))
    v, do = (torch.randn(1, S, 16, 128, generator=g, device=dev)
             .bfloat16() for _ in range(2))
    o32 = torch.empty(1, S, 16, 128, device=dev)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, out_f32=o32)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    _within(o, o_p)
    assert (lse - lse_p).abs().max().item() <= 1e-4
    assert torch.equal(o32.bfloat16(), o)
    grads = fa.flash_attention_bwd(q, k, v, o32, lse, do, causal=True)
    again = fa.flash_attention_bwd(q, k, v, o32, lse, do, causal=True)
    want = fa.flash_attention_bwd_plain(q, k, v, o32, lse_p, do, causal=True)
    for a, b, w in zip(grads, again, want):
        assert torch.equal(a, b)
        _within(a, w)


@pytest.mark.cuda
def test_the_dropless_layer_on_k6_on_the_card():
    """The MoE layer at Moonlight's widths over one row of 4096 tokens,
    K6/K6b against ``gmm_plain``: output and every gradient, and two calls
    give the same bits."""
    dev = _card()
    cfg = MOONLIGHT
    pb = __import__("repro_torch.models.module",
                    fromlist=["x"]).ParamBuilder(0, lambda p: torch.float32,
                                                 dev)
    MOE.init_moe_dropless(pb, cfg)
    p = pb.params
    x = torch.randn(1, 4096, cfg.d_model, device=dev).bfloat16()
    dy = torch.randn_like(x)
    outs = []
    for gmm in (ops.gmm, ops.gmm, gmm_plain):
        leaves = [p["moe"]["router"], p["moe"]["wi"], p["moe"]["wo"]]
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        xi = x.clone().requires_grad_(True)
        y = MOE.moe_mlp_dropless(p, cfg, xi, gmm=gmm)
        y.backward(dy)
        outs.append([y.detach(), xi.grad] + [t.grad.clone() for t in leaves])
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, w in zip(outs[0], outs[2]):
        _ulps(a, w)


def _ulps(got, want, n=8, frob=1e-2):
    """Every element within ``n`` bf16 ulps of its row's largest |value|
    (the layer's outputs and gradients are sums of terms each rounded to
    bf16 once, by the kernels in another order than the plain products,
    and cancel down to elements far smaller than the terms), and the
    relative Frobenius error under ``frob``."""
    g, w = got.float(), want.float()
    top = w.abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    assert ((g - w).abs() / (n * ulp)).max().item() <= 1.0
    assert ((g - w).norm() / w.norm()).item() <= frob


def test_the_launcher_trains_moonlight_then_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch moonlight-16b-a3b``, the
    normal path, at the reduced size on the CPU: a few steps, a checkpoint,
    a resume, and the experts' load line."""
    from repro_torch.launch import train as launch_train
    args = ["--arch", "moonlight-16b-a3b", "--reduced", "--device", "cpu",
            "--steps", "2", "--batch", "2", "--seq", "32", "--microbatches",
            "2", "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    st = launch_train.main(args)
    assert st.steps == 2 and st.ckpts == 1
    assert all(math.isfinite(x) for x in st.losses)
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines()
                if x.startswith("expert load max/mean by MoE layer: "))
    assert float(line.split()[-1]) >= 1.0
    st = launch_train.main(args + ["--resume", "--steps", "1"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert st.steps == 1 and math.isfinite(st.losses[0])
