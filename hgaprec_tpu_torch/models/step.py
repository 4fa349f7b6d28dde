"""One CAVI iteration per model variant (port of `hgaprec_tpu/models/step.py`).

Update *ordering* within an iteration is part of the algorithm and is kept
exactly as the reference stages it:

  * vb() (hgaprec.cc:919-980): theta rate uses old beta; theta swaps; beta
    rate uses the *new* theta (asymmetric staleness).
  * vb_bias() (1219-1319): same, plus bias shape slots; -novb switches to
    fully synchronous swaps (all rates from old expectations).
  * vb_hier() (1321-1436): per-row prior rates injected from the scale
    variables (set_prior_rate, gpbase.hh:163-173); scales update last from
    the *new* factor expectations.
  * vb_mle_user/item (982-1130) and vb_canny (1132-1216): one side is a
    point matrix renormalized per sweep (EM for GaP / Canny's GaP).

The step computes its result into the state's own tensors (the JAX
package donates them to the jitted step instead), so a run keeps one set
of state buffers and copies none of them but the HPF priors in effect,
which the state holds beside the scales' new values. Every old value a
later update reads is consumed or copied before its buffer is
overwritten.

With a process `group` (parallel/sharded.py) the user-side tables and
nonzeros are this rank's row block, the item-side tables are replicated,
and the only traffic is an all-reduce (SUM) of the item-side statistics
and of the K-length user-axis column sums, issued in the same order on
every rank; `row_mask` zeroes the expectations of the padding rows, so
they add nothing to those sums (the JAX step's `axis_name` and
`row_mask`, hgaprec_tpu/models/step.py:34-66).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from hgaprec_tpu_torch import config as C
from hgaprec_tpu_torch.config import ModelConfig
from hgaprec_tpu_torch.data.device import DeviceData
from hgaprec_tpu_torch.models.state import Gam, ModelState
from hgaprec_tpu_torch.ops import dense_fused, segment_fused, tail_fused
from hgaprec_tpu_torch.ops.gamma import expectations
from hgaprec_tpu_torch.ops.sweep import sweep
from hgaprec_tpu_torch.trace import span


def _write(buf: torch.Tensor, value) -> None:
    """buf := x + y for a pair (x, y), or the number `value` everywhere."""
    if isinstance(value, tuple):
        torch.add(*value, out=buf)
    else:
        buf.fill_(value)


def _update(g: Gam, shape, rate, row_mask=None) -> None:
    """A fresh posterior and its expectations, computed into g's own
    buffers: `shape` and `rate` are each a pair (x, y), written as x + y,
    or a number, written everywhere (`_write`); `row_mask` zeroes the
    expectations of padding rows. Neither may read g's buffers: they are
    overwritten here."""
    _write(g.shape, shape)
    _write(g.rate, rate)
    expectations(g.shape, g.rate, out=(g.e, g.elog))
    if row_mask is not None:
        g.e.mul_(row_mask.reshape((-1,) + (1,) * (g.e.dim() - 1)))


def _usum(x: torch.Tensor, group) -> torch.Tensor:
    """Column sum over the (possibly rank-sharded) user axis."""
    s = x.sum(0)
    if group is not None:
        dist.all_reduce(s, group=group)
    return s


def _ipsum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce an item-side accumulator computed from this rank's
    nonzeros (in place, or in a contiguous copy of a strided view, which
    the collective cannot take); returns the sum."""
    if group is not None:
        x = x.contiguous()
        dist.all_reduce(x, group=group)
    return x


def _bias_updates(cfg: ModelConfig, state: ModelState, res,
                  group=None) -> None:
    """Bias Gamma(0.3, 0.3) updates: shape += y*phi[bias slot], rate =
    prior + count of opposite-side entities (update_rate_next_all,
    hgaprec.cc:1265-1270, gpbase.hh:231-237)."""
    _update(state.theta_bias, (res.acc_bias_a, 0.3), 0.3 + cfg.m)
    _update(state.beta_bias, (_ipsum(res.acc_bias_b, group), 0.3),
            0.3 + cfg.n)


def _resolve_mode(cfg: ModelConfig, data: DeviceData) -> str:
    """The JAX package's rule (hgaprec_tpu/models/step.py:68-81)."""
    mode = cfg.resolve_sweep()
    auto = cfg.sweep == C.SWEEP_AUTO
    if mode == C.SWEEP_DENSE and data.dense_y is None:
        mode = (C.SWEEP_HYBRID if data.head_dense_y is not None
                else C.SWEEP_SEGMENT)
    if auto and mode == C.SWEEP_SEGMENT:
        if data.dense_y is not None:
            mode = C.SWEEP_DENSE       # densified despite a wide catalog
        elif data.head_dense_y is not None:
            mode = C.SWEEP_HYBRID      # head block built -> use it
    if mode == C.SWEEP_HYBRID and data.head_dense_y is None:
        mode = C.SWEEP_SEGMENT
    return mode


def cavi_step(state: ModelState, data: DeviceData, cfg: ModelConfig,
              group=None, row_mask: Optional[torch.Tensor] = None
              ) -> ModelState:
    """One CAVI iteration, written into `state`'s tensors; returns it.
    With `group`, the state and data are one rank's user shard (module
    docstring); `cfg.n` is the true user count all the same."""
    mode = _resolve_mode(cfg, data)
    if cfg.variant == C.VARIANT_BPF:
        _step_bpf(state, data, cfg, mode, group, row_mask)
    elif cfg.variant == C.VARIANT_HPF:
        _step_hpf(state, data, cfg, mode, group, row_mask)
    elif cfg.variant == C.VARIANT_MLE_USER:
        _step_mle_user(state, data, cfg, mode, group)
    elif cfg.variant in (C.VARIANT_MLE_ITEM, C.VARIANT_CANNY):
        _step_mle_item(state, data, cfg, mode,
                       cfg.variant == C.VARIANT_CANNY, group, row_mask)
    else:
        raise ValueError(cfg.variant)
    return state


def _sweep(state: ModelState, data: DeviceData, cfg: ModelConfig, mode,
           elog_a=None, elog_b=None):
    """The sweep on the state's Elog factors (or the given log point
    matrices in their place, for the MLE variants, which have no bias)."""
    eb_u = state.theta_bias.elog if cfg.bias else None
    eb_i = state.beta_bias.elog if cfg.bias else None
    return sweep(state.theta.elog if elog_a is None else elog_a,
                 state.beta.elog if elog_b is None else elog_b, eb_u, eb_i,
                 data, mode, cfg.item_block, cfg.user_block,
                 cfg.matmul_precision)


def _step_bpf(state, data, cfg, mode, group=None, row_mask=None):
    res = _sweep(state, data, cfg, mode)
    betasum = state.beta.e.sum(0)                  # old beta [K]
    old_thetasum = None if cfg.vb else _usum(state.theta.e, group)
    _update(state.theta, (res.acc_a, cfg.a), (betasum, cfg.b), row_mask)
    # vb: beta rate from the NEW theta; -novb: from the old one
    thetasum = _usum(state.theta.e, group) if cfg.vb else old_thetasum
    _update(state.beta, (_ipsum(res.acc_b, group), cfg.c),
            (thetasum, cfg.d))
    if cfg.bias:
        _bias_updates(cfg, state, res, group)


def _step_hpf(state, data, cfg, mode, group=None, row_mask=None):
    res = _sweep(state, data, cfg, mode)
    xi, eta = state.theta_rate, state.beta_rate
    # the prior rates in effect for this update, kept for the hier ELBO
    # term: the state holds them beside the scales' new values, which
    # overwrite xi and eta below, so these four copies stay
    state.theta_prior_e.copy_(xi.e)
    state.theta_prior_elog.copy_(xi.elog)
    state.beta_prior_e.copy_(eta.e)
    state.beta_prior_elog.copy_(eta.elog)
    # theta: prior rate := E[xi] per row (replacing b), plus old-beta colsum
    betarowsum = state.beta.e.sum(0)
    _update(state.theta, (res.acc_a, cfg.a),
            (xi.e[:, None], betarowsum[None, :]), row_mask)
    # beta: symmetric with the NEW theta (hgaprec.cc:1380-1386)
    thetarowsum = _usum(state.theta.e, group)
    _update(state.beta, (_ipsum(res.acc_b, group), cfg.c),
            (eta.e[:, None], thetarowsum[None, :]))
    if cfg.bias:
        _bias_updates(cfg, state, res, group)
    # scales last, from NEW factor expectations (hgaprec.cc:1398-1414):
    # shape = prior + K*prior; rate = prior + row-sums of E.
    _update(xi, cfg.ap + cfg.k * cfg.ap, (state.theta.e.sum(1), cfg.bp),
            row_mask)
    _update(eta, cfg.cp + cfg.k * cfg.cp, (state.beta.e.sum(1), cfg.dp))


def _step_mle_user(state, data, cfg, mode, group=None):
    res = _sweep(state, data, cfg, mode, elog_a=torch.log(state.theta_mle))
    betasum = state.beta.e.sum(0)                  # old beta [K]
    acc_b = _ipsum(res.acc_b, group)
    # EM normalize, into the point matrix (its old value went into the
    # sweep above)
    td = torch.div(res.acc_a, betasum[None, :], out=state.theta_mle)
    _update(state.beta, (acc_b, cfg.c), (_usum(td, group), cfg.d))


def _step_mle_item(state, data, cfg, mode, canny: bool, group=None,
                   row_mask=None):
    res = _sweep(state, data, cfg, mode, elog_b=torch.log(state.beta_mle))
    thetasum = _usum(state.theta.e, group)         # old theta [K]
    acc_b = _ipsum(res.acc_b, group)
    # into the point matrix, whose old value went into the sweep above
    if canny:
        # floor *before* normalizing (hgaprec.cc:1173-1176), then per-factor
        # L1 column normalization (1179-1187)
        bd = torch.clamp_min(acc_b, 1e-10) / thetasum[None, :]
        bd = torch.div(bd, bd.sum(0, keepdim=True), out=state.beta_mle)
    else:
        bd = torch.div(acc_b, thetasum[None, :], out=state.beta_mle)
    _update(state.theta, (res.acc_a, cfg.a), (bd.sum(0), cfg.b), row_mask)


def make_step(cfg: ModelConfig):
    """Return `step(state, data) -> state` for this config."""
    def step(state: ModelState, data: DeviceData) -> ModelState:
        return cavi_step(state, data, cfg)
    return step


def cavi_multi_step(state: ModelState, data: DeviceData, cfg: ModelConfig,
                    n_steps: int, group=None,
                    row_mask: Optional[torch.Tensor] = None) -> ModelState:
    """`n_steps` CAVI iterations back to back, with no host
    synchronisation in between: the loop (the JAX package's
    `cavi_multi_step`, one `lax.fori_loop` dispatch,
    hgaprec_tpu/models/step.py:225-238). The CPU takes it, and so does a
    sharded run over gloo, whose collectives cannot be captured
    (`captures_collectives`); on a card with no group or an NCCL group
    `GraphMultiStep` replays the same step instead."""
    for _ in range(n_steps):
        cavi_step(state, data, cfg, group, row_mask)
    return state


class CudaGraph:
    """One CUDA graph on `device`: `capture(fn)` records fn's launches on
    a side stream and runs none of them; `replay()` runs what was
    recorded."""

    def __init__(self, device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn) -> None:
        # The default ("global") capture mode holds with NCCL's
        # collectives inside, the process group's watchdog thread
        # included: torch.cuda.graph synchronizes the card before the
        # capture begins, so the warm-up step's collectives have ended,
        # and PyTorch hands no collective issued under capture to the
        # watchdog (chip_smoke.py's phase B captures a world of one's
        # step again and again, the watchdog given time between).
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            fn()

    def replay(self) -> None:
        self.graph.replay()


def captures_collectives(group) -> bool:
    """Whether a step's collectives over `group` can be captured in a CUDA
    graph: with no group, or over NCCL, whose all-reduce is a kernel on
    the card. gloo's all-reduce of a CUDA tensor copies it to the host,
    reduces there and copies it back (parallel/sharded.py::_gloo_cuda),
    a host synchronisation that no capture can hold."""
    return group is None or dist.get_backend(group) == "nccl"


def graph_capturable(state: ModelState, group) -> bool:
    """Whether steps on `state` over `group` are replayed: on a CUDA card,
    where `captures_collectives(group)`."""
    return state.theta.e.device.type == "cuda" and \
        captures_collectives(group)


# the kernel wrappers on the step's path: each counts its launches in
# `launches` (and fused_dense_sweep by kernel in `launches_by_kernel`)
_COUNTED = (dense_fused.fused_dense_sweep, tail_fused.fused_half_sweep,
            segment_fused.fused_segment_sweep)


def _launch_counts():
    return [(w.launches, dict(getattr(w, "launches_by_kernel", {})))
            for w in _COUNTED]


def _launches_since(before):
    """The launches counted since `before` (a `_launch_counts()`)."""
    return [(n1 - n0, {k: v - b0.get(k, 0) for k, v in b1.items()})
            for (n0, b0), (n1, b1) in zip(before, _launch_counts())]


def _add_launches(counts, times: int) -> None:
    for w, (n, by_kernel) in zip(_COUNTED, counts):
        w.launches += n * times
        for kernel, k in by_kernel.items():
            w.launches_by_kernel[kernel] += k * times


def tensor_leaves(tree, prefix=""):
    """(name, tensor) of every tensor in a tree of dataclasses, such as a
    ModelState or a DeviceData (whose lazily built slab caches are
    derived from these)."""
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from tensor_leaves(v, f"{prefix}{f.name}.")


def _tensor_key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


def _storage_key(state: ModelState, data: DeviceData, group=None,
                 row_mask: Optional[torch.Tensor] = None) -> tuple:
    """What a captured step is valid for: the address, shape, strides and
    type of every state and data tensor and of the row mask, and the
    group (by identity: the runner holds it, so its id is not reused)."""
    return (tuple((name, *_tensor_key(t))
                  for tree in (state, data)
                  for name, t in tensor_leaves(tree)),
            None if group is None else id(group),
            None if row_mask is None else _tensor_key(row_mask))


class GraphMultiStep:
    """`multi_step(state, data, n_steps, group=None, row_mask=None) ->
    state`: the counterpart of the JAX package's `cavi_multi_step`, and
    of the sharded run's (hgaprec_tpu/parallel/sharded.py:116-121, a
    `fori_loop` over the shard-mapped step), whose single dispatch for
    the `rfreq` iterations between two reports removes the per-step host
    round trip that dominates small and medium problems. Here one
    `cavi_step(state, data, cfg, group, row_mask)` is captured once as a
    CUDA graph and replayed; with an NCCL `group` (one rank of a sharded
    run) the graph holds the step's two all-reduces.

      * The first call makes one real step eagerly (the warm-up, an
        iteration like any other: it builds the kernels' lazily made slab
        streams, loads the kernel library and types its entries, and
        issues the step's collectives, so NCCL's communicator exists
        before the capture, created by the same calls in the same order
        on every rank), then captures one step, which runs nothing;
        every later step is a replay, so a run makes as many iterations
        as the loop.
      * The graph is valid for what it captured: it is keyed on the
        config, on the storage of every state and data tensor and of the
        row mask, and on the group, and captured anew when any of them
        changes (a state read from a checkpoint, new data, another
        shard). The step writes into the state's own buffers, so a
        replay's result is the state the caller holds. The captured
        state, data, group and row mask are kept alive with the graph,
        so their memory cannot be handed to other tensors while it may
        replay.
      * The graph's private memory pool holds one step's temporaries
        beside the allocator's cache for as long as the graph lives;
        `reset()` frees it. A graph with collectives holds work of the
        group's communicator: drop it (`reset()`) before the group goes.
      * A captured collective is not watched by the process group's
        timeout; the report boundary's synchronisation and collectives
        stay eager, outside the graph.
      * The kernel wrappers count their launches when Python calls them,
        which a replay does not: each replay adds the launches that the
        capture recorded, and the capture itself adds none. The counts
        are this process's, so a rank counts its own.
      * The loop (`cavi_multi_step`) is taken where `capturable(state,
        group)` is false: a CPU state, and a gloo group, whose
        collectives cannot be captured (`captures_collectives`); and
        everywhere with `graph=False`, which only comparisons with the
        loop ask for. On the card a failed capture or replay raises;
        nothing falls back to the loop.

    `eager_steps`, `captures` and `replays` count what the runner did;
    the warm-up step, the capture and the key's walk are spanned as
    `multistep.warmup`, `multistep.capture` and `multistep.key`
    (trace.py; only the last opens on the replay path, and it launches
    nothing).
    `new_graph` makes the capture object (`CudaGraph`) and `capturable`
    decides where steps replay (`graph_capturable`); the tests inject
    fakes of both."""

    def __init__(self, cfg: ModelConfig, graph: bool = True,
                 new_graph=CudaGraph, capturable=graph_capturable):
        self.cfg = cfg
        self.graph_on_card = graph
        self.new_graph = new_graph
        self.capturable = capturable
        self.eager_steps = self.captures = self.replays = 0
        self.reset()

    def reset(self) -> None:
        """Drop the captured graph, its memory pool and what it holds."""
        self.graph = None
        self._key = None
        self._held = None
        self._per_replay = None

    def replays_on(self, state: ModelState, group=None) -> bool:
        """Whether steps on `state` over `group` are replayed: on a CUDA
        card with no group or an NCCL group, unless the runner was made
        for the loop."""
        return self.graph_on_card and self.capturable(state, group)

    def __call__(self, state: ModelState, data: DeviceData, n_steps: int,
                 group=None, row_mask: Optional[torch.Tensor] = None
                 ) -> ModelState:
        if n_steps <= 0:
            return state
        if not self.replays_on(state, group):
            return cavi_multi_step(state, data, self.cfg, n_steps, group,
                                   row_mask)
        with span("multistep.key"):
            key = (self.cfg, _storage_key(state, data, group, row_mask))
            stale = self.graph is None or key != self._key
        if stale:
            self.reset()
            with span("multistep.warmup"):
                cavi_step(state, data, self.cfg, group, row_mask)
            self.eager_steps += 1
            n_steps -= 1
            with span("multistep.capture"):
                self._capture(state, data, group, row_mask)
            self._key = key
        for _ in range(n_steps):
            self.graph.replay()
        self.replays += n_steps
        _add_launches(self._per_replay, n_steps)
        return state

    def _capture(self, state: ModelState, data: DeviceData, group,
                 row_mask) -> None:
        before = _launch_counts()
        graph = self.new_graph(state.theta.e.device)
        graph.capture(functools.partial(cavi_step, state, data, self.cfg,
                                        group, row_mask))
        self._per_replay = _launches_since(before)
        _add_launches(self._per_replay, -1)     # the capture ran nothing
        self.captures += 1
        self.graph = graph
        self._held = (state, data, group, row_mask)


def make_multi_step(cfg: ModelConfig, graph: bool = True
                    ) -> GraphMultiStep:
    """Return `multi_step(state, data, n_steps, group=None, row_mask=None)
    -> state`: `n_steps` CAVI iterations back to back, replayed from one
    captured step on a card (with no group or an NCCL group) and the loop
    on the CPU and over gloo. `graph=False` takes the loop everywhere; it
    is there for comparisons with the loop, and no option of the program
    sets it."""
    return GraphMultiStep(cfg, graph)
