"""The port's analysis modules on the CPU against the reference's:

  * (a) ``analysis/roofline.py``: ``count_params``, ``model_flops``,
    ``decode_kv_bytes`` and ``decode_bandwidth_bound`` (same ``bw``)
    equal ``repro.analysis.roofline``'s for all ten archs and every
    shape; the pipeline terms and ``dist/pipeline/schedules`` tables equal
    the reference's over kinds x S {2, 4} x M {4, 8} x every truncation;
  * (b) one hand-made record under both packages' names: ``roofline_row``
    and ``jigsaw/costmodel.hlo_profiles`` equal the reference's, with the
    reference modules' constants set to the port's H100 ones inside the
    test;
  * (c) ``analysis/cost.py``'s counting: exact 2*M*N*K for mm, bmm and
    einsum (as ``FlopCounterMode``), bytes that scale with the data, free
    views, in-place updates of arguments outside ``temp``;
  * (d) the kernels' meta entries (``kernels/ops.py``): each of the nine
    Functions on meta tensors gives the plain version's output shapes and
    dtypes and the kernel's strides (contiguous in the public layout,
    which the SSD and RG-LRU plain versions also return; the flash plain
    versions return (B, H, S, D)-contiguous tensors, the kernels
    (B, S, H, D)), plain and under ``vmap`` (the work then counted once
    at J x B rows), and adds its kernel's work by the ``cost.py``
    formula; the formula's visible pairs equal ``pair_mask``'s.
"""
import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import roofline as j_roof
from repro.config import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.dist.pipeline import schedules as j_sched
from repro.jigsaw import costmodel as j_cost
from repro_torch.analysis import cost, roofline
from repro_torch.config import SHAPES
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.dist.pipeline import schedules
from repro_torch.jigsaw import costmodel
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ALL_ARCHS = sorted(ARCHS)


# ---------------------------------------------------------------------------
# (a) analytic terms and the pipeline tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_analytic_terms_equal_the_references(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert roofline.count_params(cfg) == j_roof.count_params(jcfg)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert roofline.model_flops(cfg, shape) == \
            j_roof.model_flops(jcfg, jshape)
        assert roofline.model_flops(cfg, shape, bwd_fraction=0.25) == \
            j_roof.model_flops(jcfg, jshape, bwd_fraction=0.25)
        assert roofline.decode_kv_bytes(cfg, shape.seq_len) == \
            j_roof.decode_kv_bytes(jcfg, shape.seq_len)
        assert roofline.decode_bandwidth_bound(
            cfg, shape.global_batch, shape.seq_len, bw=roofline.HBM_BW) == \
            j_roof.decode_bandwidth_bound(jcfg, shape.global_batch,
                                          shape.seq_len, bw=roofline.HBM_BW)


def test_held_experts_count_their_routed_share():
    """A full-width cut holding 8 of qwen3's 128 experts: each held expert
    leaf is active at top_k / num_experts, as the published ones."""
    from repro_torch.configs import full_width_config
    cfg = full_width_config("qwen3-moe-235b-a22b")
    c = roofline.count_params(cfg)
    m = cfg.moe
    routed = cfg.num_layers * 3 * m.experts_held * cfg.d_model * m.d_ff_expert
    assert c["nonembed"] - c["active"] == routed * (1 - m.top_k / m.num_experts)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cell_matrix_and_input_specs_equal_the_references(arch):
    from repro.configs import cells as j_cells
    from repro.configs import decode_token_specs as j_tokens
    from repro.configs import input_specs as j_specs
    from repro_torch.configs import cells, decode_token_specs, input_specs
    assert [c for c in cells(include_skipped=True) if c[0] == arch] == \
        [c for c in j_cells(include_skipped=True) if c[0] == arch]
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        if shape.kind != "decode":
            got, want = input_specs(cfg, shape), j_specs(jcfg, J_SHAPES[name])
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in got.items()} == \
                {k: (tuple(v.shape), str(v.dtype).replace("int32", "int64"))
                 for k, v in want.items()}
            assert all(v.device.type == "meta" for v in got.values())
        assert tuple(decode_token_specs(cfg, shape).shape) == \
            tuple(j_tokens(jcfg, J_SHAPES[name]).shape)


PIPE = [(kind, S, M, bwd) for kind in ("gpipe", "1f1b") for S in (2, 4)
        for M in (4, 8) for bwd in (None,) + tuple(range(1, S + 1))]


@pytest.mark.parametrize("kind,S,M,bwd", PIPE)
def test_pipeline_tables_and_terms_equal_the_references(kind, S, M, bwd):
    got = schedules.build(kind, S, M, bwd_stages=bwd)
    want = j_sched.build(kind, S, M, bwd_stages=bwd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert schedules.render(got) == j_sched.render(want)
    assert dataclasses.asdict(schedules.stash_plan(got)) == \
        dataclasses.asdict(j_sched.stash_plan(want))
    for cost_ in (1.0, 2.0):
        assert schedules.bubble_fraction_of(got, bwd_cost=cost_) == \
            j_sched.bubble_fraction_of(want, bwd_cost=cost_)
    kw = dict(kind=kind, bwd_stages=bwd)
    assert roofline.pipeline_bubble_fraction(S, M, **kw) == \
        j_roof.pipeline_bubble_fraction(S, M, **kw)
    assert roofline.pipeline_step_time(0.3, S, M, **kw) == \
        j_roof.pipeline_step_time(0.3, S, M, **kw)
    assert roofline.pipeline_stash_watermark(S, M, **kw) == \
        j_roof.pipeline_stash_watermark(S, M, **kw)
    cfg, jcfg = reduced_config("yi-6b"), j_reduced("yi-6b")
    assert roofline.pipeline_stash_bytes(cfg, 4, 64, S, M, **kw) == \
        j_roof.pipeline_stash_bytes(jcfg, 4, 64, S, M, **kw)
    for sp in (False, True):
        a = dict(model_parallel=2, data_parallel=2, bwd_stages=bwd,
                 sequence_parallel=sp)
        assert roofline.pipeline_tp_collective_bytes(
            cfg, 4, 64, S, M, **a) == j_roof.pipeline_tp_collective_bytes(
                jcfg, 4, 64, S, M, **a)


def j_reduced(arch):
    from repro.configs import reduced_config as r
    return r(arch)


# ---------------------------------------------------------------------------
# (b) one record, read by both packages
# ---------------------------------------------------------------------------

RECORD = {
    "arch": "yi-6b", "shape": "train_4k", "mesh": "h100", "chips": 1,
    "depth": None, "kind": "train", "flops_per_device": 4.297e13,
    "bytes_per_device": 4.15e11, "collective_bytes_per_device": 0.0,
    "collective_breakdown": {}, "num_collectives": 0,
    "per_opcode_flops": {"mm": 4.1e13},
    "memory_analysis": {"argument_size_in_bytes": 23048708096,
                        "temp_size_in_bytes": 15414747220},
    "ok": True, "tag": "",
}


def test_a_record_reads_as_the_reference_reads_it(tmp_path, monkeypatch):
    for mod in (j_roof, j_cost):
        for k in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
            monkeypatch.setattr(mod, k, getattr(roofline, k))
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    (ref_dir / "yi-6b__train_4k__pod16x16.json").write_text(json.dumps(RECORD))
    port_file = port_dir / roofline.cell_path("yi-6b", "train_4k").name
    port_file.write_text(json.dumps(RECORD))
    got = roofline.roofline_row(RECORD, get_config("yi-6b"))
    want = j_roof.roofline_row(RECORD, j_get_config("yi-6b"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.dominant == "memory"
    got, want = costmodel.hlo_profiles(port_dir), j_cost.hlo_profiles(ref_dir)
    assert set(got) == set(want) == {"yi-6b"}
    assert vars(got["yi-6b"]) == vars(want["yi-6b"])


def test_a_depth_record_profiles_the_full_step(tmp_path):
    """A record at depth d of L: fwd_s + (d / L) bwd_s is its own step."""
    rec = dict(RECORD, depth=2, layers=8, name="yi-6b", batch=2,
               seq_len=2048)
    (tmp_path / "r.json").write_text(json.dumps(rec))
    p = costmodel.hlo_profiles(tmp_path)["yi-6b"]
    step = rec["bytes_per_device"] / roofline.HBM_BW
    assert p.task_time(2 / 8) == pytest.approx(step, rel=1e-12)
    assert p.bwd_s == pytest.approx(2 * p.fwd_s, rel=1e-12)


# ---------------------------------------------------------------------------
# (c) counting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,shapes,mnk", [
    (torch.mm, ((8, 16), (16, 32)), 8 * 32 * 16),
    (torch.bmm, ((3, 8, 16), (3, 16, 32)), 3 * 8 * 32 * 16),
    (lambda a, b: torch.einsum("bij,bjk->bik", a, b),
     ((3, 5, 7), (3, 7, 11)), 3 * 5 * 11 * 7),
    (lambda a, b: a @ b, ((2, 3, 8, 16), (16, 4)), 2 * 3 * 8 * 4 * 16),
])
def test_products_count_two_mnk(fn, shapes, mnk):
    args = [torch.randn(s) for s in shapes]
    _, s = cost.count(fn, *args)
    fc = FlopCounterMode(display=False)
    with fc:
        fn(*args)
    assert s.flops == 2 * mnk == fc.get_total_flops()


def test_bytes_scale_with_data():
    f = lambda x: (x * 2.0 + 1.0).sum()
    _, small = cost.count(f, torch.ones(256, 256))
    _, big = cost.count(f, torch.ones(1024, 256))
    assert big.bytes > 3 * small.bytes
    # mul, add: read x, write a result each; sum: read, write a scalar
    n = 4 * 256 * 256
    assert small.bytes == 2 * n + 2 * n + n + 4
    assert small.flops == 3 * 256 * 256     # two elementwise, one reduction


def test_views_are_free_and_broadcasts_count_once():
    x = torch.randn(64, 32)
    _, s = cost.count(lambda t: t.t().reshape(32, 64)[:, :8].unsqueeze(0), x)
    assert s.bytes == 0 and s.flops == 0
    row = torch.randn(1, 32)
    _, s = cost.count(lambda r: r.expand(64, 32) * 2.0, row)
    assert s.bytes == 4 * 32 + 4 * 64 * 32


def test_in_place_argument_updates_are_not_temp():
    p = torch.zeros(1 << 16)
    _, s = cost.count(lambda t: t.add_(1.0).mul_(0.5), p)
    assert s.memory_analysis == {"argument_size_in_bytes": 4 << 16,
                                 "temp_size_in_bytes": 0}
    _, s = cost.count(lambda t: (t + 1.0).sum(), p)
    assert s.memory_analysis["temp_size_in_bytes"] == (4 << 16) + 4


# ---------------------------------------------------------------------------
# (d) the kernels' meta entries
# ---------------------------------------------------------------------------

B, S, H, K, D = 2, 64, 4, 2, 16
SP, SN, CHUNK = 16, 16, 32          # SSD head_dim, d_state (dispatched)
W = 48


def _flash_in(device, causal=True, window=0):
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=g)
    q, k, v, do = mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D), \
        mk(B, S, H, D)
    o, lse = ops._FlashAttention.apply(q, k, v, causal, window, None)
    q, k, v, o, lse, do = (t.to(device) for t in (q, k, v, o, lse, do))
    return (q, k, v, o, lse, do, causal, window, None)


def _ssd_in(device):
    """SSD inputs with B and C one group broadcast over the heads (a head
    stride of 0), as the model passes them."""
    g = torch.Generator().manual_seed(1)
    mk = lambda *s: torch.randn(s, generator=g)
    x, b, c = mk(B, S, H, SP), mk(B, S, 1, SN), mk(B, S, 1, SN)
    dA = -torch.rand((B, S, H), generator=g)
    cs = ops._SSD.apply(x, dA, b.expand(B, S, H, SN), c.expand(B, S, H, SN),
                        CHUNK)[2]
    dy, dst = mk(B, S, H, SP), mk(B, H, SP, SN)
    x, dA, b, c, cs, dy, dst = (t.to(device)
                                for t in (x, dA, b, c, cs, dy, dst))
    return (x, dA, b.expand(B, S, H, SN), c.expand(B, S, H, SN)), cs, dy, dst


def _rglru_in(device):
    g = torch.Generator().manual_seed(2)
    a = torch.rand((B, S, W), generator=g) * 0.9 + 0.05
    b, dh = torch.randn((B, S, W), generator=g), torch.randn((B, S, W),
                                                             generator=g)
    h = ops._RGLRU.apply(a, b)
    return tuple(t.to(device) for t in (a, b, h, dh))


FLASH_SHAPE = dict(B=B, H=H, K=K, Sq=S, Sk=S, dqk=D, dv=D, causal=True,
                   window=0, itemsize=4)
SSD_SHAPE = dict(B=B, S=S, H=H, P=SP, N=SN, chunk=CHUNK, itemsize=4,
                 groups=1)
RG_SHAPE = dict(B=B, S=S, W=W)


def _case(name, device):
    """(Function, its inputs on ``device``, {kernel: its work shape})."""
    if name.startswith("flash"):
        q, k, v, o, lse, do, causal, window, scale = _flash_in(device)
        bwd = {"flash_delta": dict(B=B, H=H, Sq=S, dv=D, itemsize=4),
               "flash_dq": FLASH_SHAPE, "flash_dkv": FLASH_SHAPE}
        return {
            "flash": (ops._FlashAttention, (q, k, v, causal, window, scale),
                      {"flash_fwd": dict(FLASH_SHAPE, with_lse=True)}),
            "flash_fwd_only": (ops._FlashAttentionFwd,
                               (q, k, v, causal, window, scale),
                               {"flash_fwd": dict(FLASH_SHAPE,
                                                  with_lse=False)}),
            "flash_bwd": (ops._FlashAttentionBwd,
                          (q, k, v, o, lse, do, causal, window, scale), bwd),
        }[name]
    if name.startswith("ssd"):
        (x, dA, b, c), cs, dy, dst = _ssd_in(device)
        return {
            "ssd": (ops._SSD, (x, dA, b, c, CHUNK),
                    {"ssd_fwd_res": SSD_SHAPE}),
            "ssd_fwd_only": (ops._SSDFwd, (x, dA, b, c, CHUNK),
                             {"ssd_fwd": SSD_SHAPE}),
            "ssd_bwd": (ops._SSDBwd, (x, dA, b, c, cs, dy, dst, CHUNK),
                        {"ssd_bwd": SSD_SHAPE}),
        }[name]
    a, b, h, dh = _rglru_in(device)
    return {
        "rglru": (ops._RGLRU, (a, b), {"rglru_fwd": RG_SHAPE}),
        "rglru_fwd_only": (ops._RGLRUFwd, (a, b), {"rglru_fwd": RG_SHAPE}),
        "rglru_bwd": (ops._RGLRUBwd, (a, h, dh), {"rglru_bwd": RG_SHAPE}),
    }[name]


FUNCTIONS = ["flash", "flash_fwd_only", "flash_bwd", "ssd", "ssd_fwd_only",
             "ssd_bwd", "rglru", "rglru_fwd_only", "rglru_bwd"]


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


def _work(shapes):
    """{kernel: {shape key: one call's record}} by the cost.py formulas."""
    return {k: {cost.shape_key(sh): {"calls": 1,
                                     "flops": cost.WORK[k](**sh)[0],
                                     "bytes": cost.WORK[k](**sh)[1]}}
            for k, sh in shapes.items()}


@pytest.mark.parametrize("name", FUNCTIONS)
def test_meta_entry_lays_out_the_kernels_outputs(name):
    fn, args, _ = _case(name, "cpu")
    plain = _outs(fn.apply(*args))
    fn, args, shapes = _case(name, "meta")
    with cost.CostMode() as mode:
        got = _outs(fn.apply(*args))
    assert [(t.shape, t.dtype, t.layout) for t in got] == \
        [(t.shape, t.dtype, t.layout) for t in plain]
    for g, p in zip(got, plain):
        assert g.device.type == "meta"
        assert g.stride() == torch.empty(g.shape).stride()
        if not name.startswith("flash"):
            assert g.stride() == p.stride()
    # the work its kernels would do, once each, by the cost.py formula
    assert mode.summary.kernels == _work(shapes)
    assert mode.summary.flops == sum(cost.WORK[k](**sh)[0]
                                     for k, sh in shapes.items())


@pytest.mark.parametrize("name", FUNCTIONS)
def test_meta_entry_under_vmap_folds_the_jobs(name):
    """Two jobs under ``torch.func.vmap``: the fold hands the meta entry
    J x B rows once; the outputs unfold to (J, ...) as on the CPU."""
    J = 2

    def run(device):
        fn, args, shapes = _case(name, device)
        dims = tuple(0 if isinstance(a, torch.Tensor) else None
                     for a in args)
        stacked = tuple(a.expand(J, *a.shape).contiguous()
                        if isinstance(a, torch.Tensor) else a for a in args)
        return _outs(torch.func.vmap(fn.apply, in_dims=dims)(*stacked)), \
            shapes

    want, _ = run("cpu")
    with cost.CostMode() as mode:
        got, shapes = run("meta")
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    # a stacked input carries its own B and C a job: the fold copies them
    # (no head stride 0 left)
    folded = {k: dict(sh, B=J * sh["B"],
                      **({"groups": H} if "groups" in sh else {}))
              for k, sh in shapes.items()}
    assert mode.summary.kernels == _work(folded)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (64, 64, True, 0), (64, 64, True, 16), (100, 200, False, 0),
    (200, 100, True, 0), (64, 64, False, 8), (33, 70, True, 40)])
def test_visible_pairs_are_the_masks(Sq, Sk, causal, window):
    assert fa.visible_pairs(Sq, Sk, causal, window) == int(
        fa.pair_mask(Sq, Sk, causal, window, "cpu").sum())


def test_a_meta_entry_refuses_what_the_card_refuses():
    """In a dry run a meta call passes the card's checks or raises as the
    card would; with nothing counting, meta is refused as a device."""
    q = torch.empty((1, 8, 2, 48), device="meta")     # no head_dim 48 kernel
    a = torch.empty((1, 8, 4), dtype=torch.bfloat16, device="meta")
    with cost.CostMode() as mode:
        with pytest.raises(ValueError, match="D=48"):
            ops.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="RG-LRU kernels take float32"):
            ops.rglru(a, a)
    assert not mode.summary.kernels
    with pytest.raises(ValueError, match="no attention kernel for device "
                                         "meta"):
        ops.flash_attention(q[..., :16], q[..., :16], q[..., :16])
    with pytest.raises(ValueError, match="no RG-LRU kernel for device meta"):
        ops.rglru(a.float(), a.float())
