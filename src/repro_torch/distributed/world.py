"""A tensor-parallel world driven from one process: the port's
counterpart of the reference's GSPMD serving (``lm_engine(tp=)``).

The reference binds an LM's parameters to a ``(data=1, model=tp)`` mesh
and lets XLA partition the engine's jitted calls.  Here the world is
``tp`` processes: rank 0 is the caller's process, ranks 1..tp-1 are
``torch.multiprocessing`` workers started with ``spawn`` (never ``fork``
after CUDA is up).  They share one gloo process group, rendezvoused over a
``FileStore`` in a temporary directory (no ports), whose collectives the
layers call (``distributed.constraints``).  Gloo is the backend because
NCCL refuses two ranks on one card, which is how a one-card host runs a
world (``devices=("cuda:0", "cuda:0")``).

Each rank holds only its cut of the parameters (``sharding_rules.
cut_leaf``: every rank draws or reads each whole leaf in turn and keeps
its slice) and of the KV cache, and runs the unchanged
``serve.engine.Engine`` over them.  ``TPEngine`` is rank 0's engine: each
protocol call (``submit``, ``drain_ready``, ``drain_all``, ``run``,
``generate``, ``reset_stats``) is sent to the workers over a pipe and run
by every rank on its own engine.  Every rank sees the same reduced
activations and gathered logits, so every rank makes the same decisions
and the calls meet in the same collectives; each call's results are
compared across ranks, and again on ``close``.

Nothing hangs and nothing degrades quietly:

- every collective carries the group's timeout (``WORLD_TIMEOUT_S``), and
  a dead peer fails the next collective at once;
- a worker that raises where rank 0 did not, dies, or does not answer
  within the timeout breaks the world: rank 0 closes it and raises; so
  does a call that raised on any rank after a collective had started
  (the ranks' engines may then differ);
- a worker whose leader dies exits (it polls its parent while idle);
- ``close()`` ends the workers and returns their kernel launch counts;
- what the layers do not cover (``refuse_uncovered``: experts that do not
  divide the group, heads that a cut would split) raises before any rank
  computes.

Every kind is covered: the token-input kinds (``lm``, MLA included,
``rwkv``, ``griffin``) are served through ``TPEngine`` and trained through
``TPTrainer`` (``tp_trainer``): every rank runs ``train/trainer.py``'s
``train_step`` on its cut under its group, on the same batches, and saves
the reference's checkpoint layout with whole leaves and moments.  The VLM and the
enc-dec kind take non-token inputs, which the ``Engine`` does not, as in
the reference; their ranks hold their cut of the parameters and no
engine, and ``TPModel.same`` runs the reference's partitioned
``prefill_fn`` (``model_prefill``: the VLM's last-token logits, the
enc-dec encode) and the enc-dec serving steps (``model_call`` of
``models/encdec.py``'s ``kept_*``) on every rank, each call's result
compared across ranks.

Kernels are built in rank 0 before the workers start
(``kernels/_build.py``), so no two ranks run ``nvcc`` into one directory.

``World.spmd`` runs one module-level function on every rank with each
rank's own arguments, inside an SPMD context over one mesh axis
(``constraints.spmd_group``): the port's ``shard_map``, under which the
pipeline (``distributed/gpipe.py``), the compressed reduction
(``compression.py``) and mesh folding (``core/folding.py``) run.  It keeps
``World.call``'s failure rules.

The parameters' sources: ``SeededParams`` (drawn from a generator's
state), ``GivenParams`` (whole trees) and ``CheckpointParams`` (each rank
restores its own cut from a checkpoint, ``checkpoint.restore(shardings=)``,
the port of the reference's elastic remesh).
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import itertools
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.common.tree import tree_map
from repro_torch.distributed import constraints as tpc
from repro_torch.distributed import sharding_rules as sr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.trainer import Trainer

WORLD_TIMEOUT_S = 60.0
_POLL_S = 0.2


def _make_group(store_path: str, rank: int, size: int, timeout_s: float):
    import torch.distributed as dist

    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    store = dist.FileStore(store_path, size)
    store.set_timeout(datetime.timedelta(seconds=timeout_s))
    return dist.ProcessGroupGloo(store, rank, size, opts)


# ---------------------------------------------------------------------------
# what every rank builds: the engine over its cut of the parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeededParams:
    """Parameters drawn as ``nninit.materialize`` draws them, leaf by leaf
    in tree order from one generator: the generator's ``state``
    (``torch.Generator.get_state()``) on a device of type ``kind``.  A CUDA
    state draws on the rank's own card; a CPU one draws on the host, each
    leaf moved to the rank's device before it is cut."""

    state: torch.Tensor
    kind: str = "cpu"

    @classmethod
    def of(cls, gen: torch.Generator) -> "SeededParams":
        return cls(gen.get_state(), gen.device.type)

    def __call__(self, spec, cut: Callable, device: torch.device):
        from repro_torch.nn import init as nninit

        gen = torch.Generator(device if self.kind == "cuda" else "cpu")
        gen.set_state(self.state)
        return tree_map(lambda p: cut(p, nninit._materialize_one(p, gen).to(device)),
                        spec)


@dataclasses.dataclass(frozen=True)
class GivenParams:
    """Whole parameters given as a tree of CPU tensors or arrays (e.g. the
    reference's, carried across by ``interop.from_reference``)."""

    tree: Any

    def __call__(self, spec, cut: Callable, device: torch.device):
        return tree_map(lambda p, a: cut(p, torch.as_tensor(np.asarray(a) if not
                                                            isinstance(a, torch.Tensor)
                                                            else a).to(device)),
                        spec, self.tree)


@dataclasses.dataclass(frozen=True)
class CheckpointParams:
    """Parameters restored from the checkpoint under ``ckpt_dir``
    (``train/checkpoint.py``; ``step`` None: the newest), each rank
    restoring only its cut: ``checkpoint.restore(shardings=)`` checks every
    leaf whole against ``template``, cuts it on the host by the world's
    rules (``sharding_rules.world_pspec``) and moves the cut to the rank's
    device, leaf by leaf, so no rank's device holds the whole model.  The
    few leaves the layers read whole (``sharding_rules.reads_whole``) are
    restored whole and cut by the world's cut, which keeps their whole
    beside it, as ``SeededParams`` does.

    ``template`` is the checkpoint's whole tree as ``meta`` tensors
    (``nninit.shapes`` of the spec; a ``Trainer``'s checkpoint holds
    ``{"opt": optimizer.state_shapes(...), "params": ...}``), ``key`` the
    subtree that holds the parameters (None: the whole tree).  Leaves
    outside it are checked against the checkpoint's index and never read
    (``checkpoint.SKIP``)."""

    ckpt_dir: str
    template: Any
    key: str | None = None
    step: int | None = None

    def __call__(self, spec, cut: Callable, device: torch.device):
        from repro_torch.train import checkpoint as ckpt

        ctx = tpc.current()
        rank, mesh = (0, make_host_mesh()) if ctx is None else (ctx.rank, ctx.mesh)
        specs = tree_map(lambda p: None if sr.reads_whole(p) else sr.world_pspec(p, mesh),
                         spec)
        shardings = specs if self.key is None else \
            {k: specs if k == self.key else ckpt.SKIP for k in self.template}
        tree, _ = ckpt.restore(self.ckpt_dir, self.template, self.step, device=device,
                               shardings=shardings, rank=rank, mesh=mesh)
        params = tree if self.key is None else tree[self.key]
        return tree_map(lambda p, t: cut(p, t.to(device)) if sr.reads_whole(p) else t,
                        spec, params)


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """What a ``TPTrainer``'s ranks train with: the ``TrainerConfig``, the
    ``AdamWConfig`` and the token pipeline's ``TokenPipelineConfig`` (one
    seed, so every rank draws the same batches)."""

    tcfg: Any
    ocfg: Any
    data: Any


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """What each rank builds: the arch, its config, the whole parameters'
    source and the engine's ``ServeConfig`` (None: no engine), or a
    trainer's ``TrainSpec``."""

    arch_id: str
    cfg: Any
    params_fn: Callable
    serve_cfg: Any
    train: TrainSpec | None = None


@dataclasses.dataclass
class RankEngine:
    """One rank's engine (None for a kind the ``Engine`` does not serve; a
    ``RankTrainer`` for a trainer, which holds the parameters it trains:
    ``params`` is then None), its tensor-parallel context, its local
    parameters and what a model's calls keep on the rank between calls
    (``state``: the enc-dec kind's encoder output and decode caches)."""

    spec: EngineSpec
    ctx: tpc.TPContext
    engine: Any
    params: Any
    device: torch.device
    state: dict = dataclasses.field(default_factory=dict)

    def run(self, fn: Callable, *args, **kwargs):
        with tpc.tp_group(self.ctx):
            return fn(*args, **kwargs)


def _split_heads(arch, cfg, tp: int) -> str | None:
    """The heads a cut at ``tp`` would split (rwkv's ``heads_flat``
    columns, which divide where its heads may not) or cut off their
    up-projections' heads (MLA, whose absorbed decode reads them per
    head), else None."""
    if arch.kind == "rwkv":
        h = cfg.d_model // cfg.head_dim
        if cfg.d_model % tp == 0 and h % tp:
            return f"rwkv's {h} heads"
    lm_cfg = cfg.lm if arch.kind == "vlm" else cfg
    if getattr(lm_cfg, "attn_kind", "gqa") == "mla" and lm_cfg.mla.n_heads % tp:
        return f"MLA's {lm_cfg.mla.n_heads} heads"
    return None


def refuse_uncovered(arch, cfg, tp: int) -> None:
    """Raise for what tensor parallelism does not cover yet: experts that
    do not divide ``tp`` (the rules would cut them along another dim) and
    heads that the cut at ``tp`` would split (``_split_heads``)."""
    lm_cfg = cfg.lm if arch.kind == "vlm" else cfg
    moe_cfg = getattr(lm_cfg, "moe", None)
    if moe_cfg is not None and moe_cfg.n_experts % tp:
        what = f"{moe_cfg.n_experts} experts"
    else:
        what = _split_heads(arch, cfg, tp)
    if what is not None:
        raise NotImplementedError(
            f"{arch.id}: tensor parallelism covers every kind where the group "
            f"divides the experts and the heads; {what} at tp={tp} wait for "
            "ROADMAP Queue 1 #9")


def build_rank(spec: EngineSpec, group, rank: int, size: int, device) -> RankEngine:
    """Rank ``rank``'s engine over its cut of ``spec``'s parameters (no
    engine where ``spec`` has no ``serve_cfg``: a ``TPModel``'s)."""
    from repro_torch.configs import base as cb
    from repro_torch.configs.registry import get_arch
    from repro_torch.serve.engine import Engine

    arch = get_arch(spec.arch_id)
    refuse_uncovered(arch, spec.cfg, size)
    device = torch.device(device)
    ctx = tpc.TPContext(group, rank, size)
    mesh = ctx.mesh
    with tpc.tp_group(ctx):
        params = spec.params_fn(cb.model_spec(arch, spec.cfg),
                                lambda p, t: sr.cut_leaf(p, t, rank, mesh), device)
        engine = None
        if spec.train is not None:
            engine, params = RankTrainer(arch, spec.cfg, params, spec.train, ctx, device), None
        elif spec.serve_cfg is not None:
            step, init = cb.serve_fns(arch, spec.cfg, spec.serve_cfg.max_len)
            engine = Engine(step, init, dataclasses.replace(spec.serve_cfg), params=params)
    return RankEngine(spec, ctx, engine, params, device)


class RankTrainer(Trainer):
    """One rank's ``Trainer`` over its cut of the parameters, run under its
    group (``RankEngine.run``): ``run`` is ``Trainer.run``; ``save`` makes
    every leaf and moment whole by the exact gather on every rank and rank
    0 writes them in the reference's layout (a checkpoint of one device's
    ``Trainer``); ``try_restore`` restores the rank's cut of such a
    checkpoint (``checkpoint.restore(shardings=)``), the leaves the layers
    read whole cut beside their whole (``sharding_rules.cut_leaf``)."""

    def __init__(self, arch, cfg, params, train: TrainSpec, ctx: tpc.TPContext, device):
        from repro_torch.configs import base as cb
        from repro_torch.data.tokens import SyntheticTokens

        self.ctx = ctx
        self.spec = cb.model_spec(arch, cfg)
        super().__init__(cb.loss_fn(arch, cfg), params, train.tcfg, train.ocfg,
                         SyntheticTokens(train.data), device=device)

    def whole_state(self):
        """The state tree with every cut made whole (a collective a leaf,
        on every rank), on the host; None on a rank other than 0."""
        keep = self.ctx.rank == 0

        def one(t, dim):
            w = t if dim is None else tpc.whole(t, dim)
            return w.cpu() if keep else None

        with torch.no_grad():
            params = tree_map(lambda t: one(t, getattr(t, "tp_dim", None)), self.params)
            mu = tree_map(lambda p, m: {k: one(v, getattr(p, "tp_dim", None))
                                        for k, v in m.items()},
                          self.params, self.opt_state["mu"])
        if not keep:
            return None
        return {"params": params, "opt": {"mu": mu, "step": self.opt_state["step"].cpu()}}

    def save(self):
        from repro_torch.train import checkpoint as ckpt

        tree = self.whole_state()
        if tree is None:
            return
        if self._ckpt is not None:
            self._ckpt.save(self.step, tree)
        else:
            ckpt.save(self.tcfg.ckpt_dir, self.step, tree)

    def try_restore(self) -> bool:
        from repro_torch.nn import init as nninit
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train import optimizer as opt_mod

        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return False
        mesh, rank, dev = self.ctx.mesh, self.ctx.rank, self.device
        shapes = nninit.shapes(self.spec)
        template = {"params": shapes, "opt": opt_mod.state_shapes(shapes, self.ocfg)}
        def cut(p):
            return sr.world_pspec(p, mesh)

        shardings = {"params": tree_map(lambda p: None if sr.reads_whole(p) else cut(p),
                                        self.spec),
                     "opt": {"mu": tree_map(lambda p: {"m": cut(p), "v": cut(p)}, self.spec),
                             "step": None}}
        tree, step = ckpt.restore(self.tcfg.ckpt_dir, template, step, device=dev,
                                  shardings=shardings, rank=rank, mesh=mesh)
        self.params = tree_map(lambda p, t: sr.cut_leaf(p, t.to(dev), rank, mesh)
                               if sr.reads_whole(p) else t, self.spec, tree["params"])
        self.opt_state = {"mu": tree["opt"]["mu"], "step": tree["opt"]["step"].to(dev)}
        self.step = step
        return True


def forward_logits(rank: RankEngine, tokens) -> torch.Tensor:
    """The full-context forward's logits (B, S, V) of ``tokens`` on this
    rank, whole (every rank gets the same); unwindowed attention layers
    launch ``flash_attn`` on the rank's heads."""
    from repro_torch.configs import base as cb
    from repro_torch.configs.registry import get_arch

    forward, readout = cb.forward_fn(get_arch(rank.spec.arch_id), rank.spec.cfg)
    toks = torch.as_tensor(tokens).to(rank.device)
    return rank.run(lambda: readout(rank.params, forward(rank.params, toks)))


def digest(y: torch.Tensor) -> tuple:
    """(shape, sum, sum of |y|): equal bits on every rank give equal
    digests, and a digest crosses the pipe where ``y`` would not."""
    yd = y.double()
    return tuple(y.shape), float(yd.sum()), float(yd.abs().sum())


def _on_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_device(v, device) for v in tree]
    return tree


def model_prefill(rank: RankEngine, inputs) -> torch.Tensor:
    """``configs.base.prefill_fn`` of the rank's kind on ``inputs``: the
    VLM's ``{patch_embeds, tokens}`` to last-token logits (B, V), the
    enc-dec kind's frames to its encoder states' mean (B, D), as the
    reference's; unwindowed attention launches ``flash_attn`` on the
    rank's heads."""
    from repro_torch.configs import base as cb
    from repro_torch.configs.registry import get_arch

    fn = cb.prefill_fn(get_arch(rank.spec.arch_id), rank.spec.cfg)
    return rank.run(lambda: fn(rank.params, _on_device(inputs, rank.device)))


def model_call(rank: RankEngine, fn: Callable, *args):
    """``fn(params, cfg, state, *args)`` on the rank, under its group: its
    parameters, its config and the dict it keeps between calls (the
    enc-dec kind's encoder states and decode caches:
    ``models/encdec.py:kept_encode`` and the steps after it), the tensor
    arguments moved to its device."""
    return rank.run(fn, rank.params, rank.spec.cfg, rank.state,
                    *_on_device(list(args), rank.device))


def digest_of(rank: RankEngine, fn: Callable, *args) -> tuple:
    """The ``digest`` of ``fn(rank, *args)``, as a worker returns it."""
    out = fn(rank, *args)
    return None if out is None else digest(out)


def peak_bytes(rank: RankEngine) -> int:
    """The rank's process's peak allocated bytes on its card (0 on the
    CPU)."""
    if rank.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(rank.device))


def to_host(tree):
    """``tree`` with every tensor moved to the host (what crosses a pipe)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _streams(out) -> dict | None:
    """The token streams of a call's results ({uid: tokens}), None for a
    call that returns none."""
    if isinstance(out, dict) and all(hasattr(r, "tokens") for r in out.values()):
        return {uid: [int(t) for t in r.tokens] for uid, r in out.items()}
    if isinstance(out, np.ndarray):
        return {"generate": out.tolist()}
    return None


# ---------------------------------------------------------------------------
# the worker process
# ---------------------------------------------------------------------------


def _worker(rank: int, size: int, store_path: str, device: str, timeout_s: float,
            threads: int, conn) -> None:
    import multiprocessing

    torch.set_num_threads(threads)
    from repro_torch.backend import registry

    conn.send(("ok", None))     # started: rank 0 may wait in the rendezvous now
    try:
        group = _make_group(store_path, rank, size, timeout_s)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        return
    conn.send(("ok", None))
    parent = multiprocessing.parent_process()
    spmd = tpc.SPMDContext(group, rank, size, device=str(torch.device(device)))
    ranks: dict[int, RankEngine] = {}
    streams: dict[int, list] = {}
    while True:
        if not conn.poll(_POLL_S):
            if parent is not None and not parent.is_alive():
                os._exit(1)
            continue
        try:
            op, args = conn.recv()
        except EOFError:
            os._exit(1)
        entered = tpc.entered()
        if op == "close":
            conn.send(("ok", {"launches": dict(registry.LAUNCHES), "streams": streams}))
            break
        out = None
        try:
            out = _run_op(op, args, ranks, streams, spmd, device)
            conn.send(("ok", out))
        except BaseException as e:  # the leader decides whether the world survives
            conn.send(("raised", (type(e).__name__, str(e), traceback.format_exc(),
                                  tpc.entered() - entered)))
        del op, args, out   # nothing of a call outlives it: a dropped model is freed


def _run_op(op: str, args, ranks: dict, streams: dict, spmd: tpc.SPMDContext,
            device: str):
    """One message's work on a worker; returns what it sends back."""
    from repro_torch.backend import registry

    if op == "build":
        handle, spec = args
        ranks[handle] = build_rank(spec, spmd.group, spmd.rank, spmd.size, device)
        streams[handle] = []
        return None
    if op == "call":
        handle, method, a, kw = args
        r = ranks[handle]
        res = _streams(r.run(getattr(r.engine, method), *a, **kw))
        if res is not None:
            streams[handle].append(res)
        return res
    if op == "fn":
        handle, fn, a = args
        return fn(ranks[handle], *a)
    if op == "spmd":
        fn, a, axis = args
        spmd.axis = axis
        with tpc.spmd_group(spmd):
            return to_host(fn(*a))
    if op == "drop":
        ranks.pop(args[0], None)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()   # the model's memory back to the card
        return None
    if op == "launches":
        return dict(registry.LAUNCHES)
    if op == "reset_launches":
        registry.reset_launches()
        return None
    raise ValueError(f"unknown world op {op!r}")


# ---------------------------------------------------------------------------
# rank 0's side
# ---------------------------------------------------------------------------


class WorldError(RuntimeError):
    """A tensor-parallel world broke: a worker died, raised where rank 0
    did not, disagreed with it or did not answer in time."""


class World:
    """``len(devices)`` ranks: rank 0 this process on ``devices[0]``, rank
    r a spawned worker on ``devices[r]``.  Each worker takes this process's
    ``torch.get_num_threads()``, split over the ranks when they all
    compute on the CPU, which they share."""

    def __init__(self, devices, timeout_s: float = WORLD_TIMEOUT_S):
        import torch.multiprocessing as mp

        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)
        if self.size < 1:
            raise ValueError("a world needs at least one device")
        self.timeout_s = timeout_s
        self.closed = False
        self.final: list[dict] = []
        self._handles = itertools.count()
        if any(d.type == "cuda" for d in self.devices):
            from repro_torch.kernels import _build

            _build.build_all()
        self._dir = tempfile.mkdtemp(prefix="repro_tp_")
        store = os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        threads = torch.get_num_threads()
        if all(d.type == "cpu" for d in self.devices):
            threads = max(1, threads // self.size)
        try:
            for r in range(1, self.size):
                ours, theirs = ctx.Pipe()
                proc = ctx.Process(target=_worker, daemon=True, args=(
                    r, self.size, store, str(self.devices[r]), timeout_s, threads, theirs))
                proc.start()
                theirs.close()
                self._procs.append(proc)
                self._conns.append(ours)
            # each worker reports once it runs (a worker that dies while it
            # starts fails here, not in the rendezvous), then once it joined
            self._replies("start")
            self.group = _make_group(store, 0, self.size, timeout_s) if self.size > 1 else None
            self._replies("start")
            self._spmd = tpc.SPMDContext(self.group, 0, self.size,
                                         device=str(self.devices[0]))
        except BaseException:
            self._end()
            raise

    # -- messages -------------------------------------------------------

    def send(self, op: str, *args, each: list | None = None) -> None:
        """``(op, args)`` to every worker, or ``(op, each[r - 1])`` to
        worker r."""
        if self.closed:
            raise WorldError("the tensor-parallel world is closed")
        for r, conn in enumerate(self._conns, 1):
            try:
                conn.send((op, args if each is None else each[r - 1]))
            except (BrokenPipeError, EOFError, OSError) as e:
                self.fail(f"rank {r} is gone ({e})")

    def _replies(self, what: str) -> list:
        """Every worker's reply: ``("ok", payload)`` or ``("raised",
        (type, message, traceback, collectives entered))``; a dead or
        silent worker breaks the world."""
        out = []
        deadline = time.monotonic() + self.timeout_s
        for r, (conn, proc) in enumerate(zip(self._conns, self._procs), 1):
            while not conn.poll(_POLL_S):
                if not proc.is_alive() and not conn.poll(0):
                    self.fail(f"rank {r} died (exit code {proc.exitcode}) during {what}")
                if time.monotonic() > deadline:
                    self.fail(f"rank {r} did not answer {what} within "
                              f"{self.timeout_s:.0f} s")
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                proc.join(timeout=1.0)
                self.fail(f"rank {r} died (exit code {proc.exitcode}) during {what}")
            if msg[0] == "error":
                self.fail(f"rank {r} failed to start:\n{msg[1]}")
            out.append(msg)
        return out

    def call(self, op: str, args: tuple, local: Callable, what: str,
             each: list | None = None):
        """Send ``op`` to the workers (``each``: worker r's own arguments,
        ``each[r - 1]``), run ``local`` here meanwhile, and
        return (its result, the workers' payloads).  If ``local`` raises,
        the world survives only where every worker raised the same type and
        no rank entered a collective during the call (a request refused
        before any work, which leaves every engine as it was); otherwise it
        is closed and ``WorldError`` raised."""
        self.send(op, *args, each=each)
        entered = tpc.entered()
        try:
            out = local()
        except BaseException as e:
            if isinstance(e, WorldError):
                raise
            mine = tpc.entered() - entered
            try:
                replies = self._replies(what)
            except WorldError as broken:
                # the message carries rank 0's own error, which a reader
                # of the output's end would not see otherwise
                raise WorldError(f"{broken}, after rank 0 raised {type(e).__name__}: "
                                 f"{str(e)[:2000]}") from e
            if not all(m[0] == "raised" and m[1][0] == type(e).__name__ for m in replies):
                theirs = "; ".join(f"rank {r}: " + ("ok" if m[0] == "ok" else
                                                    f"{m[1][0]}: {m[1][1]}\n{m[1][2]}")
                                   for r, m in enumerate(replies, 1))
                self.fail(f"rank 0 raised {type(e).__name__} during {what} and the "
                          f"workers did not ({theirs})", cause=e)
            if mine or any(m[1][3] for m in replies):
                self.fail(f"every rank raised {type(e).__name__} during {what}, after "
                          "a collective had started", cause=e)
            raise
        replies = self._replies(what)
        for r, m in enumerate(replies, 1):
            if m[0] != "ok":
                self.fail(f"rank {r} raised during {what}: {m[1][0]}: {m[1][1]}\n{m[1][2]}")
        return out, [m[1] for m in replies]

    def fail(self, msg: str, cause: BaseException | None = None):
        self._end()
        raise WorldError(f"tensor-parallel world of {self.size}: {msg}") from cause

    # -- SPMD --------------------------------------------------------------

    def spmd(self, fn: Callable, args: list, axis: str = "model") -> list:
        """``fn(*args[r])`` on every rank r at once, inside an SPMD context
        over one mesh axis ``axis`` of the world's ranks
        (``constraints.spmd_group``; each rank's context, and its ``state``,
        persists from call to call).  ``fn`` must be importable by name, and
        the workers' arguments cross a pipe: pass host tensors.  Returns
        every rank's result, rank 0's as it is and the workers' moved to
        the host.  Failures follow ``call``'s rules."""
        if len(args) != self.size:
            raise ValueError(f"spmd: {len(args)} argument tuples for {self.size} ranks")
        self._spmd.axis = axis

        def local():
            with tpc.spmd_group(self._spmd):
                return fn(*args[0])

        out, theirs = self.call("spmd", (), local, getattr(fn, "__name__", "spmd"),
                                each=[(fn, tuple(a), axis) for a in args[1:]])
        return [out, *theirs]

    @property
    def spmd_ctx(self) -> tpc.SPMDContext:
        """Rank 0's SPMD context: its collectives so far (``stats``,
        ``nbytes``); set ``timed`` to synchronise the device around each and
        add its host seconds."""
        return self._spmd

    # -- queries ----------------------------------------------------------

    def launches(self) -> list[dict]:
        """Each rank's kernel launch counts (rank 0's is this process's)."""
        from repro_torch.backend import registry

        _, theirs = self.call("launches", (), lambda: None, "launches")
        return [dict(registry.LAUNCHES), *theirs]

    def reset_launches(self) -> None:
        from repro_torch.backend import registry

        self.call("reset_launches", (), registry.reset_launches, "reset_launches")

    # -- the end ------------------------------------------------------------

    def close(self) -> list[dict]:
        """End the workers; returns each worker's last payload (its launch
        counts and the token streams of every call)."""
        if self.closed:
            return self.final
        try:
            self.send("close")
            self.final = [m[1] for m in self._replies("close")]
        finally:
            self._end()
        return self.final

    def _end(self) -> None:
        self.closed = True
        for proc in self._procs:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
        for conn in self._conns:
            conn.close()
        self.group = None
        shutil.rmtree(self._dir, ignore_errors=True)

    def __del__(self):
        if not getattr(self, "closed", True):
            self._end()


class TPModel:
    """What a world holds for one model: every rank built it
    (``build_rank``) under ``handle``.  ``same`` runs a call on every rank
    and compares the results; for the kinds the ``Engine`` does not serve
    (the VLM, the enc-dec kind: parameters and no engine on each rank)
    the calls are ``model_prefill`` (the reference's partitioned
    ``prefill_fn``) and ``model_call`` of the enc-dec serving steps
    (``models/encdec.py:kept_encode`` and those after it).
    ``owns_world``: ``close()`` closes the world too."""

    def __init__(self, world: World, spec: EngineSpec, owns_world: bool = True):
        self.world, self.spec, self.owns_world = world, spec, owns_world
        self.handle = next(world._handles)
        self.rank0, _ = world.call(
            "build", (self.handle, spec),
            lambda: build_rank(spec, world.group, 0, world.size, world.devices[0]),
            "build")

    @property
    def tp(self) -> int:
        return self.world.size

    @property
    def devices(self) -> tuple:
        return self.world.devices

    @property
    def collectives(self) -> dict:
        """Rank 0's collectives so far: op -> (count, host seconds when
        timed)."""
        return self.rank0.ctx.stats

    def on_every_rank(self, fn: Callable, *args):
        """``fn(rank_engine, *args)`` on every rank (``fn`` importable by
        name, as the workers unpickle it); returns rank 0's result and the
        workers' results."""
        return self.world.call("fn", (self.handle, fn, args),
                               lambda: fn(self.rank0, *args), getattr(fn, "__name__", "fn"))

    def same(self, fn: Callable, *args) -> torch.Tensor | None:
        """Rank 0's ``fn(rank_engine, *args)``, run on every rank (the
        workers' tensor arguments moved to the host); raises unless every
        rank's result has rank 0's ``digest``."""
        name = getattr(fn, "__name__", "fn")

        def local():
            y = fn(self.rank0, *args)
            return y, None if y is None else digest(y)

        (y, mine), theirs = self.world.call(
            "fn", (self.handle, digest_of, (fn, *to_host(args))), local, name)
        for r, d in enumerate(theirs, 1):
            if d != mine:
                self.world.fail(f"rank {r}'s result of {name} differs from rank 0's")
        return y

    def close(self) -> list[dict]:
        """End this model on every rank (and the world, if owned); returns
        the workers' last payloads when the world was closed."""
        if self.world.closed:
            return self.world.final
        if not self.owns_world:
            self.world.call("drop", (self.handle,), lambda: None, "drop")
            return []
        return self.world.close()


def trainer_run(rank: RankEngine, steps: int | None) -> tuple:
    """``Trainer.run(steps)`` on the rank, under its group; returns each
    new step's (loss, grad_norm, lr) and ``trainer_digests``."""
    before = len(rank.engine.metrics_history)
    hist = rank.run(rank.engine.run, steps)
    return ([(m["loss"], m["grad_norm"], m["lr"]) for m in hist[before:]],
            trainer_digests(rank))


def trainer_digests(rank: RankEngine, params=None) -> list:
    """The ``digest`` of every replicated leaf and of every whole kept
    beside a cut of the rank's trainer's parameters (or ``params``): the
    same on every rank of a sound world."""
    from repro_torch.common.tree import tree_leaves

    return [digest(t.tp_whole if hasattr(t, "tp_whole") else t)
            for t in tree_leaves(rank.engine.params if params is None else params)
            if hasattr(t, "tp_whole") or not hasattr(t, "tp_dim")]


def trainer_save(rank: RankEngine) -> None:
    rank.run(rank.engine.save)


def trainer_restore(rank: RankEngine) -> tuple:
    """``try_restore`` on the rank: (restored, step)."""
    ok = rank.run(rank.engine.try_restore)
    return ok, rank.engine.step


_MIRRORED = ("submit", "drain_ready", "drain_all", "run", "generate", "reset_stats")


class TPEngine(TPModel):
    """Rank 0's ``Engine`` of a tensor-parallel world: the runtime protocol
    (and ``run`` / ``generate``), each call run by every rank.  Reads
    (``cfg``, ``stats``, ``tokens_per_s()``, ...) are rank 0's engine's.
    ``owns_world``: ``close()`` closes the world too."""

    def __init__(self, world: World, spec: EngineSpec, owns_world: bool = True):
        self.streams: list = []
        super().__init__(world, spec, owns_world)
        self.engine = self.rank0.engine

    def _mirror(self, method: str, *args, **kwargs):
        out, theirs = self.world.call(
            "call", (self.handle, method, args, kwargs),
            lambda: self.rank0.run(getattr(self.engine, method), *args, **kwargs),
            method)
        mine = _streams(out)
        if mine is not None:
            self.streams.append(mine)
            for r, s in enumerate(theirs, 1):
                if s != mine:
                    self.world.fail(f"rank {r}'s token streams differ from rank 0's "
                                    f"in {method}")
        return out

    def submit(self, group):
        return self._mirror("submit", list(group))

    def drain_ready(self):
        return self._mirror("drain_ready")

    def drain_all(self):
        return self._mirror("drain_all")

    def run(self, requests):
        return self._mirror("run", list(requests))

    def generate(self, prompts, max_new_tokens: int | None = None):
        return self._mirror("generate", [np.asarray(p) for p in prompts], max_new_tokens)

    def reset_stats(self):
        return self._mirror("reset_stats")

    def forward(self, tokens) -> torch.Tensor:
        """Rank 0's ``forward_logits`` of ``tokens``, run on every rank;
        raises unless every rank's logits have rank 0's digest."""
        return self.same(forward_logits, tokens)

    def __getattr__(self, name: str):
        if name in _MIRRORED or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.__dict__["engine"], name)

    def close(self) -> list[dict]:
        """Compare every rank's token streams once more, end this engine
        on every rank (and the world, if owned); returns the workers' last
        payloads when the world was closed."""
        if self.world.closed:
            return self.world.final
        final = super().close()
        for r, payload in enumerate(final, 1):
            if payload["streams"].get(self.handle, []) != self.streams:
                raise WorldError(f"rank {r}'s token streams differ from rank 0's")
        return final


class TPTrainer(TPModel):
    """Rank 0's ``Trainer`` of a tensor-parallel world, as ``TPEngine`` is
    rank 0's ``Engine``: ``run``, ``save`` and ``try_restore`` run on every
    rank (``RankTrainer``), each rank training its cut with
    ``train_step`` on the same batches.  ``run`` raises ``WorldError``
    where a rank's losses, norms or learning rates, or the digest of a
    replicated leaf or a kept whole, differ from rank 0's.  Reads (``step``,
    ``params``, ``opt_state``, ``metrics_history``, ...) are rank 0's
    trainer's.  ``owns_world``: ``close()`` closes the world too."""

    def __init__(self, world: World, spec: EngineSpec, owns_world: bool = True):
        super().__init__(world, spec, owns_world)
        self.trainer = self.rank0.engine

    def run(self, steps: int | None = None) -> list[dict]:
        mine, theirs = self.on_every_rank(trainer_run, steps)
        for r, t in enumerate(theirs, 1):
            if t[0] != mine[0]:
                self.world.fail(f"rank {r}'s losses, norms or lrs differ from rank 0's")
            if t[1] != mine[1]:
                self.world.fail(f"rank {r}'s replicated leaves or kept wholes differ "
                                "from rank 0's")
        return self.trainer.metrics_history

    def save(self) -> None:
        self.on_every_rank(trainer_save)

    def try_restore(self) -> bool:
        mine, theirs = self.on_every_rank(trainer_restore)
        if any(t != mine for t in theirs):
            self.world.fail(f"the ranks restored differently: {[mine, *theirs]}")
        return mine[0]

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.__dict__["trainer"], name)


def tp_trainer(arch_id: str, cfg, params_fn: Callable, tp: int, devices, tcfg, ocfg,
               data, timeout_s: float = WORLD_TIMEOUT_S) -> TPTrainer:
    """A token LM (``lm``, ``rwkv``, ``griffin``) trained tensor-parallel by
    a world of ``tp`` processes on ``devices[:tp]``: each rank cuts the
    whole parameters from ``params_fn`` and trains its cut by ``tcfg`` and
    ``ocfg`` on the batches of ``data`` (a ``TokenPipelineConfig``).
    ``close()`` ends the world."""
    from repro_torch.configs.registry import get_arch

    kind = get_arch(arch_id).kind
    if kind not in ("lm", "rwkv", "griffin"):
        raise NotImplementedError(
            f"{arch_id}: a tensor-parallel trainer takes token batches (lm, rwkv, "
            f"griffin); the {kind} kind's batches wait for ROADMAP Queue 1 #10")
    return _open(TPTrainer, devices, tp,
                 EngineSpec(arch_id, cfg, params_fn, None, TrainSpec(tcfg, ocfg, data)),
                 timeout_s)


def tp_engine(arch_id: str, cfg, params_fn: Callable, tp: int, devices, serve_cfg,
              timeout_s: float = WORLD_TIMEOUT_S) -> TPEngine:
    """An LM ``Engine`` served tensor-parallel by a world of ``tp``
    processes on ``devices[:tp]`` (rank r on ``devices[r]``), over whole
    parameters from ``params_fn`` (``SeededParams`` / ``GivenParams`` /
    ``CheckpointParams``), each rank keeping its cut.  ``close()`` ends the
    world."""
    from repro_torch.configs import base as cb
    from repro_torch.configs.registry import get_arch

    cb.serve_fns(get_arch(arch_id), cfg, serve_cfg.max_len)   # the kinds it refuses
    return _open(TPEngine, devices, tp, EngineSpec(arch_id, cfg, params_fn, serve_cfg),
                 timeout_s)


def tp_model(arch_id: str, cfg, params_fn: Callable, tp: int, devices,
             timeout_s: float = WORLD_TIMEOUT_S) -> TPModel:
    """A model held tensor-parallel by a world of ``tp`` processes on
    ``devices[:tp]``, without an engine (the VLM and the enc-dec kind,
    whose inputs the ``Engine`` does not take; ``TPModel.same`` runs its
    calls), over whole parameters from ``params_fn``.  ``close()`` ends the
    world."""
    return _open(TPModel, devices, tp, EngineSpec(arch_id, cfg, params_fn, None),
                 timeout_s)


def _open(cls, devices, tp: int, spec: EngineSpec, timeout_s: float):
    devices = tuple(devices)
    if tp < 1 or tp > len(devices):
        raise ValueError(f"tp={tp} needs {tp} devices, got {len(devices)}")
    from repro_torch.configs.registry import get_arch

    refuse_uncovered(get_arch(spec.arch_id), spec.cfg, tp)
    world = World(devices[:tp], timeout_s=timeout_s)
    try:
        return cls(world, spec)
    except BaseException:
        if not world.closed:
            world._end()
        raise
