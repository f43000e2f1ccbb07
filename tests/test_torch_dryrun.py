"""The dry run on the CPU (``launch/dryrun.py``, ``analysis/cost.py``):

  * (a) the elision proof: for yi-6b, mamba2-2.7b and recurrentgemma-2b
    reduced, the counted backward FLOPs and bytes and the bytes autograd
    saves for the backward (``saved_tensors_hooks``) fall strictly with
    the SPB depth -- on the meta device with ``use_pallas`` on (the
    kernels' meta entries count the kernels) and on the CPU with it off;
  * (b) parity with the reference's HLO count: yi-6b reduced at batch
    8 x 64, depths 1-4, ``repro.models.lm.REMAT`` set to ``"none"``.  The
    port's matrix products plus the reference's attention recompute equal
    the reference's matrix ``dot`` FLOPs exactly.  The recompute: the
    reference's ``blockwise_attention`` checkpoints its kv-block scan body
    (``jax.checkpoint(body)``, ``repro/models/layers.py``) whatever REMAT
    says, so a live layer's backward recomputes S = Q K^T and P V: two
    products of 2 * B * H * S * S * D (4,194,304 FLOPs here) a live layer,
    one at depth 1, where the HLO keeps only the recomputed P V.  The
    port's eager backward keeps P.  The rest are vector products (the
    norms' and the cross-entropy's row sums, which the reference writes
    as einsums): under 0.4% of either count;
    With ``REMAT`` at ``"full"`` or ``"dots"`` on both sides (the port's
    ``remat=``) the same relation holds with one product a live layer:
    XLA merges the attention's own recompute into the layer's;
  * (d) the layer recompute, counted: ``saved_bytes`` falls none > dots >
    full at every depth, under 'full' it is the live repeats' carries
    plus what is saved outside the stack, exactly, and each live
    attention or SSD layer's forward kernel is counted twice;
  * (c) the CLI writes a record that ``analysis/report.md_dryrun``
    renders, and ``make_policy("costmodel", ...)`` then finds its profile
    without the paper's resnet50 fallback; ``--remat`` records go to
    files of their own, and ``h100_profile`` reads one policy's records,
    its memory the counted peak clamped at the card's 80 GB.
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import hlo as j_hlo
from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.engine import SPBEngine as JEngine
from repro.models import lm as j_lm
from repro_torch.analysis import cost, report, roofline
from repro_torch.config import SHAPES, SPBConfig, TrainConfig
from repro_torch.configs import input_specs, make_batch, reduced_config
from repro_torch.core import spb as spb_lib
from repro_torch.dist import steps as steps_lib
from repro_torch.engine.policies import CostModelPolicy, make_policy
from repro_torch.jigsaw import costmodel
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.tree import tree_map

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

aten = torch.ops.aten
PRODUCTS = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm)


# ---------------------------------------------------------------------------
# (a) the elision proof
# ---------------------------------------------------------------------------

def _backward_costs(cfg, device, depth):
    """(backward FLOPs, backward bytes, saved bytes) of one loss at
    ``depth``: the forward and the backward counted apart."""
    if device == "meta":
        params = tree_map(lambda t: t.requires_grad_(True),
                          lm.param_shapes(cfg))
        batch = input_specs(cfg, dataclasses.replace(
            SHAPES["train_4k"], global_batch=2, seq_len=64))
    else:
        params = tree_map(lambda t: t.requires_grad_(True),
                          lm.init_lm(torch.Generator().manual_seed(0), cfg,
                                     "cpu"))
        batch = make_batch(cfg, 2, 64, device="cpu")
    with cost.CostMode((params, batch)) as fwd:
        loss, _ = lm.loss_fn(params, batch, cfg, bwd_layers=depth)
    with cost.CostMode(params) as bwd:
        loss.backward()
    return bwd.summary.flops, bwd.summary.bytes, fwd.summary.saved_bytes


@pytest.mark.parametrize("device,use_pallas", [("meta", True),
                                               ("cpu", False)])
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_backward_work_falls_with_depth(arch, device, use_pallas):
    cfg = dataclasses.replace(reduced_config(arch), use_pallas=use_pallas)
    depths = sorted(set(spb_lib.snapped_depths(
        cfg, SPBConfig(mode="temporal", k=4))))
    assert len(depths) >= 2
    costs = [_backward_costs(cfg, device, d) for d in depths]
    for i, what in enumerate(("backward flops", "backward bytes",
                              "saved bytes")):
        seq = [c[i] for c in costs]
        assert all(a < b for a, b in zip(seq, seq[1:])), (what, depths, seq)


def test_the_meta_count_is_the_cpu_count():
    """The same step on the meta device counts what it counts on the CPU
    with data: the same ops, the same bytes, the same saved tensors."""
    cfg = reduced_config("yi-6b")
    meta = _backward_costs(cfg, "meta", 2)
    cpu = _backward_costs(cfg, "cpu", 2)
    assert meta == cpu


# ---------------------------------------------------------------------------
# (b) against the reference's HLO count
# ---------------------------------------------------------------------------

B, S, DEPTHS = 8, 64, (1, 2, 3, 4)


def _hlo_dots(text):
    """(matrix dot FLOPs, vector dot FLOPs) of a compiled module, loop
    bodies times their trip counts; a vector product has one side of
    size 1 once batch and contracting dims are set aside."""
    comps, entry = j_hlo.parse_module(text)
    out = [0.0, 0.0]

    def side(dims, batch, contract):
        n = 1
        for i, d in enumerate(dims):
            if i not in batch and i not in contract:
                n *= d
        return n

    def idx(op, key):
        v = j_hlo._attr_braces(op.attrs, key)
        return {int(i) for i in v.split(",") if i.strip()} if v else set()

    def visit(name, count):
        comp = comps.get(name)
        if comp is None:
            return
        for op in comp.ops:
            if op.opcode == "while":
                trips = j_hlo._trip_count(comps, j_hlo._attr(op.attrs,
                                                             "condition"))
                visit(j_hlo._attr(op.attrs, "body"), count * trips)
            elif op.opcode in ("call", "fusion", "async-start"):
                visit(j_hlo._attr(op.attrs, "to_apply")
                      or j_hlo._attr(op.attrs, "calls"), count)
            elif op.opcode == "conditional":
                for b in (j_hlo._attr_braces(op.attrs, "branch_computations")
                          or "").split(","):
                    visit(b.strip().lstrip("%"), count)
            elif op.opcode == "dot":
                lhs = j_hlo.first_shape_dims(comp.types[op.operands[0]])
                rhs = j_hlo.first_shape_dims(comp.types[op.operands[1]])
                m = side(lhs, idx(op, "lhs_batch_dims"),
                         idx(op, "lhs_contracting_dims"))
                n = side(rhs, idx(op, "rhs_batch_dims"),
                         idx(op, "rhs_contracting_dims"))
                out[m == 1 or n == 1] += count * j_hlo._dot_flops(op, comp)

    visit(entry, 1.0)
    return out


@pytest.fixture(scope="module")
def reference_dots():
    """The reference's compiled step table at depths 1-4 (one compile of
    the module): {depth: (all dots, matrix dots, vector dots)}."""
    token = j_lm.REMAT.set("none")
    try:
        eng = JEngine(j_reduced("yi-6b"), JTrain(optimizer="adamw"),
                      JSPB(mode="temporal", k=4))
        specs = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
                 for k in ("tokens", "labels")}
        out = {}
        for d in DEPTHS:
            text = eng.lower_step(specs, depth=d).compile().as_text()
            mat, vec = _hlo_dots(text)
            out[d] = (j_hlo.analyze(text).per_opcode_flops["dot"], mat, vec)
        return out
    finally:
        j_lm.REMAT.reset(token)


class _Products(cost.CostMode):
    """Also splits the products' FLOPs into matrix and vector ones."""

    def __init__(self, *a):
        super().__init__(*a)
        self.split = [0.0, 0.0]

    def _count(self, func, packet, args, kwargs, out):
        if packet in PRODUCTS:
            from torch.utils.flop_counter import flop_registry
            m, n = out.shape[-2], out.shape[-1]
            self.split[m == 1 or n == 1] += flop_registry[packet](
                *args, **kwargs, out_val=out)
        super()._count(func, packet, args, kwargs, out)


def _port_products(depth, remat="none"):
    cfg = reduced_config("yi-6b")
    tcfg = TrainConfig()
    state = steps_lib.state_from_params(tree_map(
        lambda t: t.requires_grad_(True), lm.param_shapes(cfg)), tcfg)
    batch = input_specs(cfg, dataclasses.replace(
        SHAPES["train_4k"], global_batch=B, seq_len=S))
    step = steps_lib.make_train_step(cfg, tcfg, SPBConfig(mode="temporal",
                                                          k=4), depth=depth,
                                     remat=remat)
    with _Products((state, batch)) as mode:
        step(state, batch)
    return mode.split


def test_matrix_products_equal_the_references_dots_but_its_recompute(
        reference_dots):
    cfg = reduced_config("yi-6b")
    one = 2.0 * B * cfg.num_heads * S * S * cfg.head_dim   # Q K^T or P V
    assert one == 4194304
    ratios = []
    for d in DEPTHS:
        ref_all, ref_mat, ref_vec = reference_dots[d]
        mat, vec = _port_products(d)
        recompute = (2 * d - (d == 1)) * one
        assert mat + recompute == ref_mat, (d, mat, recompute, ref_mat)
        assert vec < 4e-3 * mat and ref_vec < 4e-3 * ref_all
        ratios.append((mat + vec) / ref_all)
    # the products' ratio to the reference's dots, as first measured
    assert [round(r, 3) for r in ratios] == [0.988, 0.964, 0.956, 0.951]


REMAT_DEPTHS = (1, 3)


@pytest.fixture(scope="module")
def reference_dots_remat():
    """The reference's matrix dots under ``REMAT`` 'full' and 'dots' at
    depths 1 and 3: {(remat, depth): matrix dot FLOPs}."""
    out = {}
    for remat in ("full", "dots"):
        token = j_lm.REMAT.set(remat)
        try:
            eng = JEngine(j_reduced("yi-6b"), JTrain(optimizer="adamw"),
                          JSPB(mode="temporal", k=4))
            specs = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
                     for k in ("tokens", "labels")}
            for d in REMAT_DEPTHS:
                text = eng.lower_step(specs, depth=d).compile().as_text()
                out[(remat, d)] = _hlo_dots(text)[0]
        finally:
            j_lm.REMAT.reset(token)
    return out


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_matrix_products_under_the_recompute_equal_the_references(
        reference_dots_remat, remat):
    """Under 'full' the port recomputes every product of a live layer and
    the reference too, whose attention then recomputes one product more
    (its own checkpoint, merged by XLA with the layer's); under 'dots'
    both keep the projections and recompute the attention products."""
    cfg = reduced_config("yi-6b")
    one = 2.0 * B * cfg.num_heads * S * S * cfg.head_dim
    for d in REMAT_DEPTHS:
        mat, _ = _port_products(d, remat)
        none_mat, _ = _port_products(d)
        assert mat > none_mat                   # the recompute, counted
        assert mat + d * one == reference_dots_remat[(remat, d)], (remat, d)


# ---------------------------------------------------------------------------
# (d) the layer recompute, counted
# ---------------------------------------------------------------------------

def _loss_count(cfg, depth, remat, mode_cls=cost.CostMode):
    params = tree_map(lambda t: t.requires_grad_(True), lm.param_shapes(cfg))
    batch = input_specs(cfg, dataclasses.replace(
        SHAPES["train_4k"], global_batch=B, seq_len=S))
    with mode_cls((params, batch)) as mode:
        loss, _ = lm.loss_fn(params, batch, cfg, bwd_layers=depth,
                             remat=remat)
        loss.backward()
    return mode


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_saved_bytes_fall_none_dots_full(arch):
    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    for depth in (1, 2, None):
        counts = {r: _loss_count(cfg, depth, r).summary
                  for r in lm.REMAT_POLICIES}
        saved = [counts[r].saved_bytes for r in ("none", "dots", "full")]
        assert saved[0] > saved[1] > saved[2], (depth, saved)
        flops = [counts[r].flops for r in ("none", "dots", "full")]
        assert flops[0] < flops[1] < flops[2], (depth, flops)


def test_full_keeps_the_carries_and_what_lies_outside_the_stack(
        monkeypatch):
    """Under 'none' the saves made inside a live repeat and outside the
    stack are told apart; under 'full' the saves outside are the same
    bytes and the repeats keep their carries: x (B x S x d_model f32) at
    each live repeat, one aux scalar and the positions (S int64)."""
    cfg = reduced_config("yi-6b")
    run_repeat = lm._run_repeat

    class Split(cost.CostMode):
        inside = 0
        outside_bytes = 0.0

        def _pack(self, t):
            before = self.summary.saved_bytes
            out = super()._pack(t)
            if not self.inside:
                self.outside_bytes += self.summary.saved_bytes - before
            return out

        def _kept(self, tensors, nbytes):
            self.inside += 1
            try:
                super()._kept(tensors, nbytes)
            finally:
                self.inside -= 1

    modes = []

    def repeat(*a, **k):
        modes[-1].inside += 1
        try:
            return run_repeat(*a, **k)
        finally:
            modes[-1].inside -= 1

    monkeypatch.setattr(lm, "_run_repeat", repeat)

    def split(*a):
        modes.append(Split(*a))
        return modes[-1]

    carry = B * S * cfg.d_model * 4
    for depth in (1, 2, 3, 4):
        none = _loss_count(cfg, depth, "none", split)
        full = _loss_count(cfg, depth, "full", split)
        assert full.outside_bytes == none.outside_bytes
        assert full.summary.saved_bytes == (
            none.outside_bytes + depth * carry + 4 + S * 8), depth


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b"])
def test_full_counts_each_live_forward_kernel_twice(arch):
    """A non-reentrant checkpoint runs a live layer's forward with grad
    on, so its first pass takes the forward-with-residuals kernel, and
    the recompute runs it again; frozen layers run once."""
    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    L = cfg.num_layers
    for depth in (1, 2, L):
        calls = {k: v["calls"] for k, v in
                 _loss_count(cfg, depth, "full").summary.kernel_totals()
                 .items()}
        if arch == "yi-6b":
            want = {"flash_fwd": L + depth, "flash_delta": depth,
                    "flash_dq": depth, "flash_dkv": depth}
        else:
            want = {"ssd_fwd": L - depth, "ssd_fwd_res": 2 * depth,
                    "ssd_bwd": depth}
        assert calls == {k: n for k, n in want.items() if n}, depth


# ---------------------------------------------------------------------------
# (c) the CLI, the report and the cost model
# ---------------------------------------------------------------------------

def test_cli_record_renders_and_feeds_the_cost_model(tmp_path, monkeypatch,
                                                     capsys):
    argv = ["--arch", "yi-6b", "--reduced", "--shape", "train_4k",
            "--batch", "2", "--seq", "64", "--depth", "2", "--out",
            str(tmp_path)]
    assert dryrun.main(argv) == 0
    assert "OK  yi-6b" in capsys.readouterr().out
    (path,) = tmp_path.glob("*.json")
    assert path.name == "yi-6b__train_4k__h100__reduced__b2x64__d2.json"
    table = report.md_dryrun(tmp_path)
    assert "| yi-6b | reduced 2x64 | train_4k | 2 |" in table
    assert "| yi-6b | reduced 2x64 | 2/4 |" not in report.md_spb(tmp_path)

    cfg = reduced_config("yi-6b")
    spb = SPBConfig(mode="temporal", k=4)
    monkeypatch.setattr(roofline, "RESULTS", tmp_path)
    # one depth: the profile is found, its split the reference's 1:2
    with pytest.warns(UserWarning, match="split assumed 1:2") as got:
        pol = make_policy("costmodel", cfg, spb)
    assert not [w for w in got if "resnet50" in str(w.message)]
    assert isinstance(pol, CostModelPolicy)
    assert vars(pol.profile) == vars(
        costmodel.hlo_profiles(tmp_path)["yi-6b-reduced"])
    assert pol.profile.fwd_s > 0 and pol.profile.bwd_s == pytest.approx(
        2 * pol.profile.fwd_s)
    # a second depth counts the split: no warning at all
    depth = argv.index("--depth") + 1
    assert dryrun.main(argv[:depth] + ["4"] + argv[depth + 1:]) == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pol = make_policy("costmodel", cfg, spb)
    recs = {r["depth"]: r for r in roofline.records(tmp_path)}
    t = {d: costmodel._roofline_step(recs[d]) for d in (2, None)}
    assert pol.profile.task_time(2 / 4) == pytest.approx(t[2], rel=1e-12)
    assert pol.profile.task_time(1.0) == pytest.approx(t[None], rel=1e-12)
    # the published 32-layer yi-6b is not the 4-layer cut of the records
    with pytest.warns(UserWarning, match="resnet50"):
        make_policy("costmodel", dataclasses.replace(cfg, num_layers=32),
                    spb)

    # --multi-pod writes a record of one rank of the (2, 16, 16) mesh: an
    # error record where the batch does not split over its 32 DP ranks, a
    # counted one where it does; neither feeds the one-card cost model
    assert dryrun.main(argv + ["--multi-pod"]) == 0
    bad = json.loads((tmp_path / "yi-6b__train_4k__pod2x16x16__reduced__"
                      "b2x64__d2.json").read_text())
    assert not bad["ok"] and "divisible by 32" in bad["error"]
    batch = argv.index("--batch") + 1
    assert dryrun.main(argv[:batch] + ["64"] + argv[batch + 1:]
                       + ["--multi-pod"]) == 0
    good = json.loads((tmp_path / "yi-6b__train_4k__pod2x16x16__reduced__"
                       "b64x64__d2.json").read_text())
    assert good["ok"] and (good["chips"], good["data_parallel"],
                           good["model_parallel"]) == (512, 32, 16)
    assert "ERR yi-6b" in capsys.readouterr().out
    assert vars(make_policy("costmodel", cfg, spb).profile) == vars(
        pol.profile)
    with pytest.raises(ValueError, match="SPB suffix"):
        dryrun.count_cell("yi-6b", "decode_32k", cut="reduced", depth=2,
                          batch=2, seq_len=64)


def test_remat_records_and_the_h100_profile(tmp_path, monkeypatch, capsys):
    """``--remat full`` writes a record of its own beside 'none''s; each
    policy's profile reads its own records; an H100 profile's memory is
    the counted peak, clamped at 80 GB where the reference's profile (and
    ``hlo_profiles``) clamps at 8 and 16."""
    monkeypatch.setattr(roofline, "RESULTS", tmp_path)
    argv = ["--arch", "yi-6b", "--reduced", "--shape", "train_4k",
            "--batch", "2", "--seq", "64", "--out", str(tmp_path)]
    for remat in ("none", "full"):
        for depth in ("2", "4"):
            assert dryrun.main(argv + ["--depth", depth, "--remat",
                                       remat]) == 0
    assert "remat=full" in capsys.readouterr().out
    stem = "yi-6b__train_4k__h100__reduced__b2x64"
    assert sorted(p.name for p in tmp_path.glob("*.json")) == sorted(
        f"{stem}{d}.json" for d in ("__d2", "__d2__remat-full", "",
                                    "__remat-full"))
    recs = {(r["remat"], r["depth"]): r for r in roofline.records(tmp_path)}
    assert len(recs) == 4
    assert recs[("full", 2)]["saved_bytes"] < recs[("none", 2)]["saved_bytes"]
    assert recs[("full", 2)]["flops_per_device"] > \
        recs[("none", 2)]["flops_per_device"]
    assert "remat-full" in report.md_spb(tmp_path)
    cfg = reduced_config("yi-6b")
    prof = {r: costmodel.h100_profile(cfg, tmp_path, remat=r)
            for r in ("none", "full")}
    assert prof["none"][1] and prof["full"][1]          # split counted
    # the recompute adds backward time and takes peak memory away
    assert prof["full"][0].bwd_s > prof["none"][0].bwd_s
    assert prof["full"][0].mem_peak_gb < prof["none"][0].mem_peak_gb
    assert costmodel.h100_profile(cfg, tmp_path, remat="dots") == (None,
                                                                   False)
    ma = recs[("none", None)]["memory_analysis"]
    peak = (ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]) / 2**30
    assert prof["none"][0].mem_peak_gb == pytest.approx(peak, rel=1e-12)
    # the clamps bite on a record whose state passes the reference's 8 GB
    big = dict(recs[("none", None)], name="big", layers=99)
    big["memory_analysis"] = {"argument_size_in_bytes": 30 * 2**30,
                              "temp_size_in_bytes": 60 * 2**30}
    h100, _ = costmodel._profile("big", [big], costmodel.H100_CLAMPS)
    tpu, _ = costmodel._profile("big", [big])
    assert (h100.mem_fwd_gb, h100.mem_peak_gb) == (30.0, 80.0)
    assert (tpu.mem_fwd_gb, tpu.mem_peak_gb, tpu.grad_gb) == (8.0, 16.0,
                                                              4.0)


def test_a_depth_sweep_renders(tmp_path, monkeypatch):
    """A full record and a depth record of one cell make an SPB row; the
    roofline's readers find them."""
    monkeypatch.setattr(roofline, "RESULTS", tmp_path)
    for depth in (None, 1):
        dryrun.run_cell("yi-6b", "train_4k", cut="reduced", depth=depth,
                        batch=2, seq_len=32)
    rec = roofline.load_record("yi-6b", "train_4k", depth=1, cut="reduced",
                               batch=2, seq_len=32)
    assert rec["depth"] == 1 and rec["layers"] == 4 and rec["ok"]
    (row,) = roofline.full_table()
    assert row.arch == "yi-6b" and row.dominant in ("compute", "memory")
    assert "yi-6b" in roofline.format_table([row])
    table = report.md_spb(tmp_path)
    assert "| yi-6b | reduced 2x32 | 1/4 |" in table
    assert "| yi-6b | reduced 2x32 | 4/4 |" in table
    assert "| yi-6b | reduced 2x32 | train_4k | chips" not in table
    roof = report.md_roofline(results_dir=tmp_path)
    assert "| yi-6b | reduced 2x32 | train_4k | 1 |" in roof
