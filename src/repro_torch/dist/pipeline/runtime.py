"""Schedule interpreter: run a pipeline work table on this rank's stage
(the counterpart of ``repro/dist/pipeline/runtime.py``).

Each stage is a rank of a ``dist/group.PipeGroup``, and each rank walks
its own column of the static table, tick by tick: at every tick it runs
its item, if any, then posts that tick's point-to-point messages --
activations to the right neighbour, cotangents to the left -- and waits
on them (``PipeGroup.exchange``).  Both ends read the same table, so every
send meets its receive.  The reference interprets the same table inside
``shard_map``, one ``lax.switch`` branch a stage, with ``ppermute``
between ticks.

* **FWD m.**  Stage 0 reads ``xs[m]``; any other stage takes the
  activation it received.  The input is kept in the ring slot
  :func:`schedules.stash_plan` assigns (a value read in the tick it
  arrives needs none), and the stage's forward runs under
  ``torch.no_grad()``, on live stages too, so only the input is kept.  The
  output goes right.  The last stage computes the head loss and its
  gradient in the same tick on a detached copy of the output: that gives
  the head's gradients and seeds the output cotangent (times ``1 / M``).
* **BWD m.**  The stage's forward is recomputed from the stashed input
  under grad and the received cotangent is backpropagated (the
  reference's ``jax.vjp`` on the stashed input); the weight gradients
  accumulate, and the input's cotangent goes left (from a stage whose
  left neighbour runs backward) or, at stage 0 with
  ``capture_input_grads``, is kept for the embedding's backward.  No
  microbatch's autograd graph outlives its tick, so the stashes hold
  what the table's watermark says: ``stash_slots`` is ``(plan.act_slots,
  plan.cot_slots)``.
* **Frozen stages** (SPB truncation: no backward items in the table) run
  forward only.  Their gradients are ``None`` (zero) and they launch no
  backward kernel.
* **MoE.**  With ``stage_aux`` every stage fn returns ``(y, aux)``: the
  aux values add up over stages and microbatches (a mean over
  microbatches), and each backward seeds the extra cotangent
  ``aux_weight / M``.
* **Data axis.**  Under a ``data`` axis of D ranks each rank gets its rows
  of every microbatch; the loss, aux, weight and head gradients are
  averaged over the stage's data group and the input cotangents scaled
  by ``1 / D``.  With ``zero2_dims`` (ZeRO-2) a stage-weight gradient is
  reduce-scattered over the data group on the dim its ZeRO-1 moments
  shard instead, so the rank keeps its slice alone.
* **Model axis.**  Tensor-sharded stages (``group.model`` of T ranks) run
  their joins inside the stage fns.  Under ``sequence_parallel`` a stage
  sees its slice of the sequence alone, so the gradient of a leaf every
  model rank holds whole (a norm's scale; ``model_sharded`` False) is a
  partial sum and is summed over the model group.

The loss and aux are summed over the stages (an all-reduce over the stage
axis), so every rank returns them.  A stage's weight gradients stay on
its rank; the head's are on the last stage, the input cotangents on the
first.  On the card each item is followed by a synchronization, so
``busy_s`` (the host seconds of the items) is the device's share of the
step and the rest is the bubble and the messages.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from repro_torch.dist.group import TAG_ACT, TAG_COT, PipeGroup
from repro_torch.dist.pipeline import schedules as sch
from repro_torch.dist.pipeline.schedules import FWD, Schedule
from repro_torch.tree import tree_leaves, tree_map


def _tree_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _add(acc, new, scale: float = 1.0):
    return [a if g is None else (g * scale if a is None else a + g * scale)
            for a, g in zip(acc, new)]


def run_schedule(sched: Schedule,
                 stage_fn: Union[Callable, Sequence[Callable]],
                 stage_params, xs, *, group: Optional[PipeGroup] = None,
                 loss_fn: Optional[Callable] = None, ys=None,
                 head_params=None, capture_input_grads: bool = False,
                 stage_aux: bool = False, aux_weight: float = 0.0,
                 act_shape=None, sequence_parallel: bool = False,
                 model_sharded=None, zero2_dims=None) -> Dict[str, Any]:
    """Interpret ``sched`` on this rank's stage of ``group`` (None: a
    pipeline of one rank).

    ``stage_fn(w, x) -> y`` with ``y.shape == x.shape``, or a sequence of
    per-stage fns (``stage.make_stage_fns``), of which this rank runs its
    own; ``stage_params``: this stage's ``w`` (a tree of tensors; the
    reference takes the ``(S, ...)`` stack).  ``xs``: ``(M, mb, ...)``
    microbatches, read on stage 0 only; another stage may pass ``None``
    and ``act_shape=(shape, dtype)`` of one microbatch instead.  With
    ``loss_fn(head_params, y, ys[m]) -> scalar`` the run is a training
    pass (``ys`` and ``head_params`` are read on the last stage).

    Returns ``outs`` (the last stage's ``(M, mb, ...)`` outputs, else
    None), ``loss`` (mean over microbatches), ``aux``, ``stage_grads``
    (this stage's, shaped as ``stage_params``, ``None`` leaves on a frozen
    stage), ``head_grads`` (last stage), ``input_grads`` (stage 0 with
    ``capture_input_grads``), ``stash_slots`` (the table's ``(act, cot)``
    watermark) and ``busy_s``.  ``model_sharded`` (a tree like
    ``stage_params`` of bools) marks the leaves the model axis shards, and
    ``zero2_dims`` (ints or None) the dim each leaf's gradient
    reduce-scatters on over the data axis."""
    group = group or PipeGroup()
    if sequence_parallel and group.model.size > 1 and model_sharded is None:
        raise ValueError("sequence_parallel over a model axis needs "
                         "model_sharded: which leaves' gradients to sum")
    head_params = {} if head_params is None else head_params
    s_, m_ = sched.num_stages, sched.num_microbatches
    if group.num_stages != s_:
        raise ValueError(f"a {s_}-stage table on a pipeline of "
                         f"{group.num_stages} stages")
    s = group.stage
    stage_fns = (list(stage_fn) if isinstance(stage_fn, (list, tuple))
                 else [stage_fn] * s_)
    if len(stage_fns) != s_:
        raise ValueError(f"{len(stage_fns)} stage fns for {s_} stages")
    fn = stage_fns[s]
    train = loss_fn is not None
    if sched.bwd_stages > 0 and not train:
        raise ValueError("schedule has backward items but no loss_fn")
    first, last = s == 0, s == s_ - 1
    if xs is not None:
        if xs.shape[0] != m_:
            raise ValueError(f"xs carries {xs.shape[0]} microbatches, "
                             f"schedule expects {m_}")
        mb_shape, dt, dev = tuple(xs.shape[1:]), xs.dtype, xs.device
    elif first:
        raise ValueError("stage 0 reads xs")
    else:
        (mb_shape, dt), dev = act_shape, group.device
        mb_shape = tuple(mb_shape)
    plan = sch.stash_plan(sched)
    fwd_at = [[None] * s_ for _ in range(sched.num_ticks)]
    bwd_at = [[None] * s_ for _ in range(sched.num_ticks)]
    for t, it in sched.items():
        (fwd_at if it.kind == FWD else bwd_at)[t][it.stage] = it.microbatch
    has_bwd = sched.stage_has_bwd(s)
    # the input's cotangent is needed iff someone to the left consumes
    # it: the left neighbour runs backward, or the caller wants it
    need_dx = (first and capture_input_grads) or \
        (not first and sched.stage_has_bwd(s - 1))

    w_leaves = tree_leaves(stage_params)
    dw = [None] * len(w_leaves)
    h_leaves = tree_leaves(head_params) if (last and train) else []
    head_dw = [None] * len(h_leaves)
    act_stash = [None] * plan.act_slots
    cot_stash = [None] * plan.cot_slots
    outs = [None] * m_ if last else None
    in_grads = [None] * m_ if (first and capture_input_grads) else None
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
    inv_m = 1.0 / m_
    aux_ct = torch.tensor(aux_weight * inv_m, dtype=torch.float32,
                          device=dev)
    sync = dev.type == "cuda"
    recv_act = recv_cot = None
    busy = 0.0

    for t in range(sched.num_ticks):
        in_act_m = fwd_at[t - 1][s - 1] if (t > 0 and not first) else None
        in_cot_m = bwd_at[t - 1][s + 1] if (t > 0 and not last
                                            and has_bwd) else None
        if in_act_m is not None and (s, in_act_m) in plan.act_slot:
            act_stash[plan.act_slot[(s, in_act_m)]] = recv_act
        if in_cot_m is not None and (s, in_cot_m) in plan.cot_slot:
            cot_stash[plan.cot_slot[(s, in_cot_m)]] = recv_cot
        fm, bm = fwd_at[t][s], bwd_at[t][s]
        y_send = dx_send = None
        t0 = time.perf_counter()
        if fm is not None:
            if first:
                x_in = xs[fm]
            elif in_act_m == fm:            # arrived this tick: the wire
                x_in = recv_act
            else:
                slot = plan.act_slot[(s, fm)]
                x_in = act_stash[slot]
                if not has_bwd:             # its last read
                    act_stash[slot] = None
            with torch.no_grad():
                out = fn(stage_params, x_in.detach())
            if stage_aux:
                y, aux_v = out
                aux_acc = aux_acc + aux_v.float() * inv_m
            else:
                y = out
            y_send = None if last else y
            if last:
                outs[fm] = y
                if train:
                    hp = [p.detach().requires_grad_(True) for p in h_leaves]
                    yd = y.detach().requires_grad_(has_bwd)
                    with torch.enable_grad():
                        val = loss_fn(_tree_like(head_params, hp), yd,
                                      ys[fm])
                        wrt = hp + ([yd] if has_bwd else [])
                        got = torch.autograd.grad(val, wrt,
                                                  allow_unused=True)
                    loss_acc = loss_acc + val.detach().float()
                    head_dw = _add(head_dw, got[:len(hp)], inv_m)
                    if has_bwd:
                        cot_stash[plan.cot_slot[(s, fm)]] = \
                            (got[-1] * inv_m).to(dt)
        if bm is not None:
            if first:
                x_b = xs[bm]
            else:
                slot = plan.act_slot[(s, bm)]
                x_b, act_stash[slot] = act_stash[slot], None
            if in_cot_m == bm and (s, bm) not in plan.cot_slot:
                dy = recv_cot               # consumed on arrival
            else:
                slot = plan.cot_slot[(s, bm)]
                dy, cot_stash[slot] = cot_stash[slot], None
            x_b = x_b.detach().requires_grad_(need_dx)
            wg = [p.detach().requires_grad_(True) for p in w_leaves]
            with torch.enable_grad():
                out = fn(_tree_like(stage_params, wg), x_b)
                y, aux_v = out if stage_aux else (out, None)
                ys_, cots = [y], [dy]
                if aux_v is not None and aux_v.requires_grad:
                    ys_.append(aux_v)
                    cots.append(aux_ct)
                got = torch.autograd.grad(
                    ys_, wg + ([x_b] if need_dx else []), cots,
                    allow_unused=True)
            dw = _add(dw, got[:len(wg)])
            if need_dx:
                if first:
                    in_grads[bm] = got[-1]
                else:
                    dx_send = got[-1]
            del out, y, aux_v, got
        if sync and (fm is not None or bm is not None):
            torch.cuda.synchronize(dev)
        busy += time.perf_counter() - t0
        if t + 1 < sched.num_ticks:
            sends, recvs = [], []
            if y_send is not None:
                sends.append((y_send, s + 1, TAG_ACT))
            if dx_send is not None:
                sends.append((dx_send, s - 1, TAG_COT))
            want_act = not first and fwd_at[t][s - 1] is not None
            want_cot = not last and has_bwd and bwd_at[t][s + 1] is not None
            if want_act:
                recvs.append((mb_shape, dt, s - 1, TAG_ACT))
            if want_cot:
                recvs.append((mb_shape, dt, s + 1, TAG_COT))
            got = group.exchange(sends, recvs)
            recv_act = got.pop(0) if want_act else None
            recv_cot = got.pop(0) if want_cot else None

    group.busy_s += busy
    both = torch.stack([loss_acc, aux_acc])
    if train:
        group.pipe_all_reduce(both)
    loss, aux = both[0] * inv_m, both[1]
    model, data = group.model, group.data
    if sequence_parallel and model.size > 1:
        sharded = tree_leaves(model_sharded)
        dw = [g if g is None or sh else model.all_reduce(g)
              for g, sh in zip(dw, sharded)]
    if data.size > 1:
        inv_d = 1.0 / data.size
        dims = tree_leaves(zero2_dims) if zero2_dims is not None \
            else [None] * len(dw)
        for i, (g, dim) in enumerate(zip(dw, dims)):
            if g is None:
                continue
            if dim is None:
                data.all_reduce(g).mul_(inv_d)
            else:
                dw[i] = data.reduce_scatter(g, dim).mul_(inv_d)
        for g in head_dw:
            if g is not None:
                data.all_reduce(g).mul_(inv_d)
        both = data.all_reduce(torch.stack([loss, aux])) * inv_d
        loss, aux = both[0], both[1]
        if in_grads is not None:
            in_grads = [g * inv_d for g in in_grads]
    return {"outs": torch.stack(outs) if last else None,
            "loss": loss, "aux": aux,
            "stage_grads": _tree_like(stage_params, dw),
            "head_grads": _tree_like(head_params, head_dw)
            if (last and train) else None,
            "input_grads": torch.stack(in_grads) if in_grads is not None
            else None,
            "stash_slots": (plan.act_slots, plan.cot_slots),
            "busy_s": busy}


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def pipeline_apply(stage_fn: Callable, stage_params, xs, *,
                   group: Optional[PipeGroup] = None,
                   num_microbatches: Optional[int] = None, act_shape=None):
    """GPipe forward (the :func:`schedules.gpipe_forward` table) of this
    rank's stage; returns the ``(M, mb, ...)`` outputs on the last stage,
    None elsewhere.  A stage other than 0 may pass ``xs=None`` with
    ``num_microbatches`` and ``act_shape``."""
    group = group or PipeGroup()
    m_ = xs.shape[0] if xs is not None else num_microbatches
    sched = sch.gpipe_forward(group.num_stages, m_)
    return run_schedule(sched, stage_fn, stage_params, xs, group=group,
                        act_shape=act_shape)["outs"]


def pipeline_train_grads(sched: Schedule,
                         stage_fn: Union[Callable, Sequence[Callable]],
                         stage_params, xs, ys, loss_fn: Callable, *,
                         group: Optional[PipeGroup] = None,
                         head_params=None,
                         capture_input_grads: bool = False,
                         stage_aux: bool = False, aux_weight: float = 0.0,
                         act_shape=None, sequence_parallel: bool = False,
                         model_sharded=None,
                         zero2_dims=None) -> Dict[str, Any]:
    """One pipelined forward and backward pass per the table on this
    rank's stage (:func:`run_schedule` with a loss): ``loss`` is the mean
    of ``loss_fn(head_params, y_m, ys[m])`` over microbatches, and
    ``stage_grads`` the exact d(loss)/d(w) of a stage the table runs
    backward on (``None`` on a frozen one)."""
    return run_schedule(sched, stage_fn, stage_params, xs, group=group,
                        loss_fn=loss_fn, ys=ys, head_params=head_params,
                        capture_input_grads=capture_input_grads,
                        stage_aux=stage_aux, aux_weight=aux_weight,
                        act_shape=act_shape,
                        sequence_parallel=sequence_parallel,
                        model_sharded=model_sharded, zero2_dims=zero2_dims)


def sequential_reference(stage_fn: Callable, stage_params, xs):
    """Oracle in one process: every microbatch through all stages in turn.
    ``stage_params``: ``(S, ...)`` stacked per-stage weights; ``xs``:
    ``(M, mb, ...)``.  Differentiable by autograd."""
    num_stages = tree_leaves(stage_params)[0].shape[0]
    outs = []
    for x in xs.unbind(0):
        for s in range(num_stages):
            x = stage_fn(tree_map(lambda t, s=s: t[s], stage_params), x)
        outs.append(x)
    return torch.stack(outs)
