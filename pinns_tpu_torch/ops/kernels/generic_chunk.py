"""K9 for the generic step: a chunk of the generic Adam step's epochs replayed
from one captured CUDA graph of an epoch.

It ports JAX's ``make_chunked`` (``pinns_tpu/train/trainer.py:835-869``, a
``lax.scan`` that runs a chunk of epochs as one device call) scanning
``make_adam_step`` (``:685-721``) for every configuration that K3's fused
step does not take: the Euler, weak-form and shock-path presets,
``burgers_forward`` and the other fixed-batch Burgers presets. It does for
the generic step what ``fused_step.FusedChunk`` does for K3 and
``lbfgs.LBFGSChunk`` for K10: no host call of the step inside a chunk.

The epoch is ``train.trainer.make_adam_epoch``'s, the per-epoch step's own
code: the loss forward through the kernels (K7a, K5, K7b, K1), autograd's
backward through their ``autograd.Function``s (they launch on the current
stream, so the backward lands in the capture), the multi-tensor Adam at the
learning rate and bias corrections of the schedule row at a device cursor,
K11's draw from that row (``ops.kernels.sampling``), the ADMM or causal
tail, and the metrics row at the cursor. Its results are copied back into
the runner's state buffers, then the cursor advances, all inside the graph.
So one graph replayed L times runs L epochs, and a chunk equals the
per-epoch loop (``train.trainer.run_chunk``) bit for bit.

The scope (:func:`generic_chunk_supported`) is decided by the configuration
before anything runs. A capture or a replay that fails raises: nothing falls
back to the per-epoch loop. Scratch the kernels' wrappers allocate inside the
capture lives in the graph's private pool and is never cached by them; the
constants the step reads (``device.constant``) are made by the uncaptured
warm-up epoch.

On a CPU problem the runner runs the same epochs eagerly over its buffers
(its plain version, for the tests); the trainer takes it only on the card.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.opt.adam import AdamState, tree_map
from pinns_tpu_torch.train import schedule

GRAPH_REPLAYS = 0  # replays of a captured generic epoch in this process (chip_smoke.py reads it)
GRAPH_EPOCHS = 0  # epochs run inside those replays (one a replay)
CAPTURES = 0  # epochs captured (one a configuration of fed / rho)
_lock = threading.Lock()


def generic_chunk_supported(exp, spec) -> List[str]:
    """Why ``exp``'s generic Adam chunks stay on the per-epoch loop on the
    card (empty when they replay a captured epoch). Every float32 generic
    configuration with one microbatch an epoch is inside: euler_admm,
    euler_admm_tuned, euler_inverse, euler_weak, euler_weak_fast,
    euler_weak_tail's Adam epochs, twosin_weak, burgers_forward,
    burgers_inverse, burgers_batch_l1sq, hwan_l2, hwan_admm."""
    s = exp.sampling
    reasons = [
        (s.microbatch > 1,
         f"sampling.microbatch={s.microbatch} (burgers_scale: 128 microbatches an epoch, "
         "device-bound at about 5% idle, so a graph gains it nothing, and its microbatches' "
         "saved streams would stay in the graph's pool)"),
        (spec.mixed, "the mixed stream policy (model.compute_dtype; K6 runs burgers_scale's "
                     "per-epoch loop)"),
        (spec.dtype != torch.float32,
         f"model.dtype={exp.model.dtype!r} (float64 Adam training on the card is left to a "
         "later slice: ROADMAP queue 2)"),
    ]
    return [why for bad, why in reasons if bad]


def _kernel_counters() -> List[Tuple[object, str]]:
    """(module, name) of every launch counter the generic step's kernels
    keep."""
    from pinns_tpu_torch.ops.kernels import mlp_forward, sampling, taylor1, taylor2, weakform

    return [(m, name) for m in (taylor2, mlp_forward, taylor1, weakform, sampling)
            for name in sorted(vars(m)) if name.endswith("LAUNCHES")
            and isinstance(getattr(m, name), int)]


def _copy_into(dst, src) -> None:
    """Each leaf of ``src`` into the leaf of ``dst`` at its place (dict keys
    matched by name), skipping a leaf that already is its buffer."""
    pairs = []
    tree_map(lambda d, s: pairs.append((d, s)), dst, src)
    pairs = [(d, s) for d, s in pairs if s is not d and s.data_ptr() != d.data_ptr()]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _clone(tree):
    return tree_map(torch.clone, tree)


def _admm_map(fn, admm: Optional[ADMMState]):
    if admm is None:
        return None
    return ADMMState(z=tree_map(fn, admm.z), dual=tree_map(fn, admm.dual))


class GenericChunk:
    """K9 for the generic step: chunks of ``epoch`` (``train.trainer.
    make_adam_epoch``'s) replayed from one captured CUDA graph of an epoch.

    Allocated at the first chunk, from the state's shapes, and kept: the
    state buffers (the params tree, Adam's mu and nu, the ADMM z and dual,
    the batch), a schedule of ``max_len`` rows (``train.trainer.
    adam_schedule``), an int64 device cursor, ``max_len`` metrics rows and,
    for fed batches, ``max_len`` batches. A chunk of L epochs (:meth:`run`)
    copies the state into the buffers, writes its L schedule rows, zeroes
    the cursor and replays the epoch's graph L times with no host sync; the
    state comes back in tensors of the caller's own, its epoch and Adam's
    count advanced by L.

    Captured once per (fed, rho), after one uncaptured warm-up epoch on a
    side stream (every kernel's set-up and the step's constants happen
    there), into one memory pool the runner's graphs share (they never run
    at once). The seed, the epoch, the learning rate, the bias corrections
    and the curriculum's bounds are in the schedule, so one graph serves
    every seed and every chunk. A chunk longer than ``max_len`` reallocates
    the rows and captures anew. Given points (``new_colloc``) take a graph
    that reads them through the cursor.

    The replays add the captured epoch's kernel launches to their wrappers'
    counters, L times, and count themselves in ``GRAPH_REPLAYS`` and
    ``GRAPH_EPOCHS``. Raises ``NotImplementedError`` outside
    :func:`generic_chunk_supported`.
    """

    def __init__(self, problem, learning_rate, epoch, max_len: Optional[int] = None):
        bad = generic_chunk_supported(problem.exp, problem.spec)
        if bad:
            raise NotImplementedError(
                f"{problem.exp.name!r} runs the per-epoch loop: " + "; ".join(bad))
        self.problem, self.learning_rate, self.epoch = problem, learning_rate, epoch
        self.device = problem.device
        self.on_card = self.device.type == "cuda"
        self.bufs: Optional[dict] = None
        self.cursor = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.graphs: Dict[Tuple[bool, float], torch.cuda.CUDAGraph] = {}
        self.launches: Dict[Tuple[object, str], int] = {}  # a captured epoch's, by counter
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self.capture_seconds: List[float] = []
        self._rows(max(1, int(problem.exp.train.chunk if max_len is None else max_len)))

    def _rows(self, n: int) -> None:
        """Schedule, metrics and feed rows for chunks of up to ``n`` epochs
        (the graphs hold their addresses: capture anew)."""
        self.max_len = n
        self.sched = torch.zeros((n, schedule.ROW_WORDS), dtype=torch.int32, device=self.device)
        self.metrics = torch.zeros((n, 7), dtype=torch.float32, device=self.device)
        self.feed = None
        self.graphs.clear()

    def _alloc(self, state) -> None:
        opt = state.opt_state
        self.bufs = {"params": _clone(state.params), "mu": _clone(opt.mu), "nu": _clone(opt.nu),
                     "admm": _admm_map(torch.clone, state.admm),
                     "colloc": state.colloc.clone()}

    def _load(self, state) -> None:
        b, opt = self.bufs, state.opt_state
        if (state.admm is None) != (b["admm"] is None) or state.colloc.shape != b["colloc"].shape:
            raise ValueError("K9 (generic): the state does not match the runner's buffers")
        _copy_into([b["params"], b["mu"], b["nu"], b["colloc"]],
                   [state.params, opt.mu, opt.nu, state.colloc])
        if b["admm"] is not None:
            _copy_into([b["admm"].z, b["admm"].dual], [state.admm.z, state.admm.dual])

    def _run_epoch(self, fed: bool, rho) -> None:
        """One epoch from the buffers into the buffers at the cursor's row,
        then the cursor's advance: what the graph captures."""
        from pinns_tpu_torch.train.trainer import TrainState, metrics_row

        b = self.bufs
        state = TrainState(params=b["params"], opt_state=AdamState(0, b["mu"], b["nu"]),
                           admm=b["admm"], colloc=b["colloc"], key=0, epoch=0, rho=rho)
        new_colloc = self.feed.index_select(0, self.cursor)[0] if fed else None
        params, opt, admm, colloc, metrics = self.epoch(state, self.sched, self.cursor,
                                                        new_colloc)
        # the row first: a trainable coefficient's metric is a view of the
        # params the epoch started from, which the copies below overwrite
        self.metrics.index_copy_(0, self.cursor, metrics_row(metrics)[None])
        _copy_into([b["params"], b["mu"], b["nu"], b["colloc"]],
                   [params, opt.mu, opt.nu, colloc])
        if admm is not None:
            _copy_into([b["admm"].z, b["admm"].dual], [admm.z, admm.dual])
        self.cursor.add_(1)

    def _capture(self, fed: bool, rho) -> torch.cuda.CUDAGraph:
        global CAPTURES
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # the warm-up: every set-up outside capture
            self._run_epoch(fed, rho)
        torch.cuda.current_stream(self.device).wait_stream(side)
        counters = _kernel_counters()
        before = {c: getattr(*c) for c in counters}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            self._run_epoch(fed, rho)
        # a capture launches nothing: its calls are the epoch's launches in
        # every replay, counted there
        self.launches = {c: getattr(*c) - before[c] for c in counters}
        for (m, name), v in before.items():
            setattr(m, name, v)
        torch.cuda.synchronize(self.device)
        self.capture_seconds.append(time.perf_counter() - t0)
        with _lock:
            CAPTURES += 1
        return graph

    def run(self, state, length: int, new_colloc: Optional[torch.Tensor] = None):
        """``length`` epochs from ``state``: (state, metrics) as the
        per-epoch loop (``train.trainer.run_chunk``) gives them, bit for bit.
        ``new_colloc`` (length, N_f, 2) replaces the Philox draws."""
        global GRAPH_REPLAYS, GRAPH_EPOCHS
        if length < 1:
            raise ValueError(f"K9 (generic): a chunk of {length} epochs")
        if length > self.max_len:
            self._rows(length)
        fed = new_colloc is not None
        if fed and self.feed is None:
            self.feed = torch.zeros((self.max_len,) + tuple(state.colloc.shape),
                                    dtype=state.colloc.dtype, device=self.device)
        if self.bufs is None:
            self._alloc(state)
        rho = None if state.rho is None else float(state.rho)
        from pinns_tpu_torch.train.trainer import adam_schedule

        rows = adam_schedule(self.problem, self.learning_rate, state.key,
                             state.opt_state.count, state.epoch, length)
        self.sched[:length].copy_(schedule.to_device(rows, self.device))
        if fed:
            self.feed[:length].copy_(new_colloc.reshape(self.feed[:length].shape))
        if self.on_card and (fed, rho) not in self.graphs:
            self._load(state)
            self.cursor.zero_()
            self.graphs[(fed, rho)] = self._capture(fed, rho)
        self._load(state)
        self.cursor.zero_()
        if self.on_card:
            graph = self.graphs[(fed, rho)]
            for _ in range(length):
                graph.replay()
            with _lock:
                for (m, name), n in self.launches.items():
                    setattr(m, name, getattr(m, name) + n * length)
                GRAPH_REPLAYS += length
                GRAPH_EPOCHS += length
        else:
            for _ in range(length):
                self._run_epoch(fed, rho)
        return hand_back(state, self.bufs, self.metrics, length)


def hand_back(state, bufs: dict, metrics: torch.Tensor, length: int):
    """The state after ``length`` epochs from ``state`` whose last one wrote
    the buffers ``bufs``, as tensors of the caller's own (the next chunk
    writes the buffers): the epoch and Adam's count advanced by ``length``;
    and the metrics, {metric: (length,)} from a copy of the chunk's rows."""
    from pinns_tpu_torch.train.trainer import METRIC_KEYS

    opt = state.opt_state
    rows = metrics[:length].clone()
    new_state = state._replace(
        params=_clone(bufs["params"]),
        opt_state=AdamState(count=opt.count + length, mu=_clone(bufs["mu"]),
                            nu=_clone(bufs["nu"])),
        admm=_admm_map(torch.clone, bufs["admm"]), colloc=bufs["colloc"].clone(),
        epoch=state.epoch + length)
    return new_state, {k: rows[:, j] for j, k in enumerate(METRIC_KEYS)}

