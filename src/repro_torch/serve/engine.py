"""Slot-based continuous-batching serving engine for the LM.

The port of ``repro.serve.engine.Engine``.  The engine owns a fixed pool
of ``max_slots`` KV-cache slots of ``max_len`` tokens each.  Requests wait
in a FIFO queue and are admitted as soon as a slot frees up: admission runs
one ragged, padded prefill for the whole admission group, scanning the
prompts through ``decode_step`` with every slot's position clamped to its
prompt length, then merges the admitted rows into the pool.  Recurrent
state (rwkv, griffin) would take the pad steps in, so under
``stateful_prefill`` admission runs one exact-length scan per distinct
prompt length instead, in ascending length, as the reference does; the
engine turns the flag on by itself when ``init_caches`` carries the
``stateful_prefill`` tag (``configs.base.serve_fns`` sets it).  Decode runs
``decode_block`` tokens per block with every live slot at its own position;
a slot that samples EOS or spends its budget retires and emits ``pad_id``
to the block's end, and freed slots are refilled only at block boundaries,
so ``slot_steps`` / ``active_slot_steps`` count as in the reference.

The reference runs a block as one jitted ``lax.scan``; the port runs it as
a loop of eager steps whose state (token, position, liveness, budget) stays
on the device, and reads the block's emissions back once at its end.

Sampling.  Every request's stream is keyed by (``seed``, uid) and every
token by its index in the request, and each draw takes a
``torch.Generator`` seeded from that triple (Gumbel-max over the
temperature-scaled, top-k-masked logits).  So a request's tokens do not
depend on its slot, its co-residents or the admission order, the
reference's invariant.  They are not ``jax.random``'s streams.

The engine implements the runtime protocol (``serve.runtime
.EngineProtocol``): ``submit`` one admission group, ``drain_ready`` (one
decode block, freed slots refilled) and ``drain_all``; ``run`` is the
offline loop over them and gives the same token streams as serving the
same uids online.  Stats split warmup from measured runs: a run that first
meets a shape (the first decode block, a new padded prefill length) is
warmup, as in the reference, where such a run compiles.

Not ported: ``LockstepEngine`` (the bench baseline, ROADMAP Queue 1 #8).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.serve import runtime as rt
from repro_torch.serve.runtime import GroupRecord

_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32      # default per-request generation budget
    temperature: float = 0.0      # 0 = greedy, > 0 = categorical sampling
    top_k: int | None = None      # restrict sampling to the k best logits
    eos_id: int | None = None     # stop + retire the slot when sampled
    pad_id: int = 0               # emitted by retired slots after EOS
    max_slots: int = 4            # KV slot pool size == decode batch
    max_len: int = 128            # per-slot KV capacity (prompt + new tokens)
    decode_block: int = 8         # tokens per decode block
    prefill_bucket: int = 16      # pad prompt scans to a multiple of this
    # exact-length prefill scans, one per distinct prompt length (recurrent
    # state cannot absorb pad steps); forced on by a tagged init_caches, and
    # a caller may set it, as a deploy() option (so a trace's options) can
    stateful_prefill: bool = False
    # sampling streams are keyed by (seed, uid, token index): see the module
    seed: int = 0


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (P,) int32
    max_new_tokens: int | None = None  # falls back to ServeConfig default
    # traffic class for overload control; the engine ignores it
    priority: str = "standard"


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray        # generated ids, EOS included when hit
    prompt_len: int
    finished_by_eos: bool
    slot: int                 # which slot served the request


@dataclasses.dataclass
class _Slot:
    request: Request | None = None
    tokens: list = dataclasses.field(default_factory=list)
    budget: int = 0
    served: int = 0           # requests completed by this slot (reuse stat)


def _fresh_stats(max_slots: int) -> dict:
    return {
        "requests": 0, "tokens": 0, "decode_blocks": 0,
        "slot_steps": 0, "active_slot_steps": 0, "prefills": 0,
        "decode_time_s": 0.0, "wall_time_s": 0.0,
        "slots_served": [0] * max_slots,
        # runs that first met a shape land in "warmup", the rest in
        # "measured" (``work`` == generated tokens)
        **rt.fresh_split_stats(),
    }


def stream_seed(seed: int, uid: int, index: int) -> int:
    """The 64-bit seed of token ``index`` of request ``uid``'s stream (uids
    differing anywhere in their low 64 bits, the sign included, get
    distinct streams)."""
    words = [seed & _U32, (seed >> 32) & _U32, uid & _U32, (uid >> 32) & _U32,
             index & _U32]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def _device_of(params) -> torch.device:
    for leaf in tree_leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class Engine:
    """Continuous-batching generation over an arch adapter's decode_step.

    ``decode_step(params, caches, token (B,), pos (B,)) -> (caches, logits)``
    must accept a per-slot position vector.  ``init_caches(batch, device)``
    allocates a zeroed cache tree whose leaves carry a batch axis, with a
    per-slot capacity of at least ``cfg.max_len`` for positional caches
    (``configs.base.serve_fns`` takes the same ``max_len``).  The engine
    allocates its caches on the device of ``params``.

    ``params`` is bound at construction (``configs.base.lm_engine`` binds
    it), so the engine implements the params-free runtime protocol.
    ``clock`` stamps the ``GroupRecord``s (a front door injects its own);
    ``wall`` is the real clock the throughput accounting reads.
    """

    def __init__(self, decode_step: Callable, init_caches: Callable,
                 cfg: ServeConfig, params=None, clock=time.perf_counter,
                 wall=time.perf_counter):
        # configs.base.serve_fns tags init_caches for archs whose cumulative
        # recurrent state bucketed pad steps would corrupt: honour the tag,
        # so that no caller has to set the flag
        if getattr(init_caches, "stateful_prefill", False) and not cfg.stateful_prefill:
            cfg = dataclasses.replace(cfg, stateful_prefill=True)
        self.cfg = cfg
        self.init_caches = init_caches
        self.params = params
        self.device = _device_of(params)
        self.clock = clock
        self.wall = wall
        self._decode_step = decode_step
        # batch axis per cache leaf: the one axis whose size tracks `batch`
        big, small = init_caches(2, self.device), init_caches(1, self.device)

        def batch_axis(a, b):
            for i, (x, y) in enumerate(zip(a.shape, b.shape)):
                if x != y:
                    return i
            raise ValueError(
                f"a cache leaf has shape {tuple(a.shape)} at any batch size — "
                "every leaf needs an axis that tracks the slot count")

        self._batch_axes = tree_map(batch_axis, big, small)
        del big, small
        self.stats = _fresh_stats(cfg.max_slots)
        self.runs: list[dict] = []    # per-run records from run()
        self._queue: collections.deque = collections.deque()
        self._slots = [_Slot() for _ in range(cfg.max_slots)]
        self._caches = None           # allocated on first submit
        self._state: dict | None = None
        self._ready: dict[int, Result] = {}
        self._resident: set[int] = set()   # queued or slot-resident uids
        self._open: list[GroupRecord] = []
        self._rec_left: dict[int, int] = {}    # rec.index -> unfinished uids
        self._uid_rec: dict[int, GroupRecord] = {}
        self._next_index = 0
        self._warmed: set = set()     # shapes met (prefill length, decode)
        self._cold_run = False

    # -- device-side pieces -------------------------------------------------

    def _sample(self, logits: torch.Tensor, streams: Sequence) -> torch.Tensor:
        """Greedy when temperature == 0, else top-k categorical per row.

        ``streams[i]`` is ``(uid, token index)`` of row i's request (None
        for a row whose draw is not read)."""
        cfg = self.cfg
        if cfg.temperature <= 0.0:
            return logits.argmax(dim=-1)
        scaled = logits.float() / cfg.temperature
        if cfg.top_k is not None:
            k = min(cfg.top_k, scaled.shape[-1])
            kth = torch.topk(scaled, k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, -torch.inf, scaled)
        vocab = scaled.shape[-1]
        noise = []
        for stream in streams:
            gen = torch.Generator(device=scaled.device)
            gen.manual_seed(stream_seed(cfg.seed, *stream) if stream else 0)
            u = torch.rand(vocab, generator=gen, device=scaled.device)
            noise.append(-torch.log(-torch.log(u)))
        return (scaled + torch.stack(noise)).argmax(dim=-1)

    def _prefill(self, caches, tokens: torch.Tensor, plens: torch.Tensor):
        """Ragged-prompt prefill: (B, P) right-padded tokens + (B,) lengths.

        Scans the prompt through decode_step into ``caches``.  Positions are
        clamped to each prompt's length, so every pad step past it rewrites
        the one cache entry at ``plen``, which the first decode step (also
        at ``plen``) overwrites before attending; unclamped positions would
        wrap a ring-buffer cache and clobber real entries.  Returns
        (caches, each row's logits at its last real prompt token)."""
        n = tokens.shape[1]
        idx = torch.clamp(plens - 1, 0, n - 1)
        last = None
        for t in range(n):
            caches, logits = self._decode_step(self.params, caches, tokens[:, t],
                                               torch.clamp(plens, max=t))
            last = logits if last is None else torch.where((idx == t)[:, None],
                                                           logits, last)
        return caches, last

    def _merge(self, scratch, admit: np.ndarray):
        """Copy the admitted slots' rows from the scratch caches into the
        pool, in place."""
        rows = torch.as_tensor(np.nonzero(admit)[0], device=self.device)

        def one(axis, dst, src):
            dst.index_copy_(axis, rows, src.index_select(axis, rows))

        tree_map(one, self._batch_axes, self._caches, scratch)

    def _decode_block(self, tok, pos, active, budget, streams):
        """``decode_block`` steps over the pool; ``streams[i]`` is row i's
        (uid, first token index) or None.  Returns the final (tok, pos)
        and the (steps, B) emissions and validity."""
        cfg = self.cfg
        toks, valid = [], []
        for k in range(cfg.decode_block):
            self._caches, logits = self._decode_step(self.params, self._caches,
                                                     tok, pos)
            nxt = self._sample(logits, [s and (s[0], s[1] + k) for s in streams])
            emit = torch.where(active, nxt, cfg.pad_id)
            pos = torch.where(active, pos + 1, pos)
            budget = torch.where(active, budget - 1, budget)
            toks.append(emit)
            valid.append(active)
            alive = active & (budget > 0) & (pos < cfg.max_len)
            if cfg.eos_id is not None:
                alive = alive & (emit != cfg.eos_id)
            tok, active = emit, alive
        return tok, pos, torch.stack(toks), torch.stack(valid)

    # -- host-side scheduling ----------------------------------------------

    def _budget(self, req: Request) -> int:
        return (req.max_new_tokens if req.max_new_tokens is not None
                else self.cfg.max_new_tokens)

    def _validate(self, req: Request):
        plen, budget = len(np.asarray(req.prompt).reshape(-1)), self._budget(req)
        if plen == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if budget < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens must be >= 1")
        if plen + budget > self.cfg.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {plen} + budget {budget} "
                f"exceeds max_len {self.cfg.max_len}")

    def _ensure_pool(self):
        if self._caches is None:
            n = self.cfg.max_slots
            self._caches = self.init_caches(n, self.device)
            self._state = {
                "tok": np.full((n,), self.cfg.pad_id, np.int64),
                "pos": np.zeros((n,), np.int64),
                "active": np.zeros((n,), bool),
                "budget": np.zeros((n,), np.int64),
                "gen": np.zeros((n,), np.int64),   # per-request token counter
            }

    def _active(self) -> bool:
        return self._state is not None and bool(self._state["active"].any())

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _admit(self):
        """Fill free slots from the queue: one ragged batched prefill, or
        under ``stateful_prefill`` one exact-length prefill per distinct
        prompt length."""
        cfg, slots = self.cfg, self._slots
        free = [i for i, s in enumerate(slots) if s.request is None]
        if not free or not self._queue:
            return
        group = []
        while free and self._queue:
            group.append((free.pop(0), self._queue.popleft()))
        for slot_idx, req in group:
            slots[slot_idx].request = req
            slots[slot_idx].tokens = []
            slots[slot_idx].budget = self._budget(req)

        if cfg.stateful_prefill:
            # one exact-length scan per distinct prompt length (state-safe)
            by_len: dict[int, list] = {}
            for slot_idx, req in group:
                by_len.setdefault(len(req.prompt), []).append((slot_idx, req))
            plan = [(items, length) for length, items in sorted(by_len.items())]
        else:
            plen_max = max(len(r.prompt) for _, r in group)
            plan = [(group, -(-plen_max // cfg.prefill_bucket) * cfg.prefill_bucket)]
        for items, padded in plan:
            self._prefill_group(items, padded)

    def _prefill_group(self, items, padded: int):
        """Prefill ``items`` ((slot, request) pairs) as one scan of
        ``padded`` steps, merge their rows into the pool and take each
        one's first token."""
        cfg, slots, state = self.cfg, self._slots, self._state
        if ("prefill", padded) not in self._warmed:
            self._warmed.add(("prefill", padded))
            self._cold_run = True
        tokens = np.full((cfg.max_slots, padded), cfg.pad_id, np.int64)
        plens = np.zeros((cfg.max_slots,), np.int64)
        admit = np.zeros((cfg.max_slots,), bool)
        for slot_idx, req in items:
            p = np.asarray(req.prompt, np.int64).reshape(-1)
            tokens[slot_idx, : len(p)] = p
            plens[slot_idx] = len(p)
            admit[slot_idx] = True
            # the group's first work reaches the device here
            rec = self._uid_rec.get(req.uid)
            if rec is not None and rec.dispatch_t is None:
                rec.dispatch_t = self.clock()

        scratch = self.init_caches(cfg.max_slots, self.device)
        scratch, last_logits = self._prefill(scratch, self._to_device(tokens),
                                             self._to_device(plens))
        self._merge(scratch, admit)
        del scratch
        self.stats["prefills"] += 1

        # first token: each admitted request's stream at index 0 (other rows
        # are computed and never read)
        streams = [None] * cfg.max_slots
        for slot_idx, req in items:
            streams[slot_idx] = (req.uid, 0)
        first = self._sample(last_logits, streams).cpu().numpy()
        for slot_idx, req in items:
            state["tok"][slot_idx] = first[slot_idx]
            state["pos"][slot_idx] = plens[slot_idx]
            state["active"][slot_idx] = True
            state["budget"][slot_idx] = slots[slot_idx].budget
            state["gen"][slot_idx] = 1
        # a first token can already finish the request (EOS / budget 1)
        for slot_idx, req in items:
            self._push_token(slot_idx, int(first[slot_idx]))

    def _push_token(self, i: int, token: int):
        """Record one generated token; retire the slot when done."""
        cfg = self.cfg
        slot, state = self._slots[i], self._state
        slot.tokens.append(token)
        state["budget"][i] -= 1
        hit_eos = cfg.eos_id is not None and token == cfg.eos_id
        if hit_eos or state["budget"][i] <= 0:
            req = slot.request
            self._ready[req.uid] = Result(
                uid=req.uid, tokens=np.asarray(slot.tokens, np.int32),
                prompt_len=len(req.prompt), finished_by_eos=hit_eos, slot=i)
            self.stats["requests"] += 1
            self.stats["tokens"] += len(slot.tokens)
            self.stats["slots_served"][i] += 1
            slot.served += 1
            slot.request = None
            state["active"][i] = False
            self._resident.discard(req.uid)
            rec = self._uid_rec.pop(req.uid, None)
            if rec is not None:
                self._rec_left[rec.index] -= 1
                if not self._rec_left[rec.index]:
                    del self._rec_left[rec.index]
                    rec.done_t = self.clock()
                    self._open.remove(rec)

    def _decode_once(self):
        """One decode block over the resident slots."""
        if "decode" not in self._warmed:
            self._warmed.add("decode")
            self._cold_run = True
        state, slots = self._state, self._slots
        streams = [(s.request.uid, int(state["gen"][i])) if s.request is not None
                   and state["active"][i] else None for i, s in enumerate(slots)]
        t0 = self.wall()
        tok, pos, toks, valid = self._decode_block(
            self._to_device(state["tok"]), self._to_device(state["pos"]),
            self._to_device(state["active"]), self._to_device(state["budget"]),
            streams)
        toks, valid = toks.cpu().numpy(), valid.cpu().numpy()
        self.stats["decode_time_s"] += self.wall() - t0
        self.stats["decode_blocks"] += 1
        self.stats["slot_steps"] += toks.size
        self.stats["active_slot_steps"] += int(valid.sum())
        state["tok"] = tok.cpu().numpy()
        state["pos"] = pos.cpu().numpy()
        state["gen"] = state["gen"] + valid.sum(axis=0)
        # replay emissions on the host mirror (handles retirement)
        for k in range(toks.shape[0]):
            for i in np.nonzero(valid[k])[0]:
                if slots[i].request is not None:
                    self._push_token(int(i), int(toks[k, i]))

    def _step(self):
        """One scheduler step: admit waiting requests, decode one block,
        refill freed slots at the boundary."""
        self._admit()
        if self._active():
            self._decode_once()
            self._admit()

    def _take_ready(self) -> dict[int, Result]:
        out, self._ready = self._ready, {}
        return out

    # -- group-level API (the front door drives these) ----------------------

    @property
    def admission_cap(self) -> int:
        """Largest admission group ``submit`` accepts (the slot pool)."""
        return self.cfg.max_slots

    @property
    def inflight(self) -> int:
        """Dispatched-but-undrained admission groups."""
        return len(self._open)

    @property
    def accepting(self) -> bool:
        """True while ``submit`` would start real work promptly: no earlier
        requests are still queued waiting for slots."""
        return not self._queue

    def submit(self, group: Sequence[Request]) -> GroupRecord:
        """Dispatch one admission group: enqueue, prefill what fits.

        Requests that don't fit the free slots wait in the FIFO queue and
        are prefilled as slots retire (during ``drain_*`` calls).  The
        returned ``GroupRecord`` gets ``dispatch_t`` at the prefill of the
        group's first admitted request and ``done_t`` when its last request
        finishes."""
        group = list(group)
        if self.params is None:
            raise ValueError(
                "engine has no params bound — pass params= to Engine "
                "(configs.base.lm_engine binds them for you)")
        if not group:
            raise ValueError("empty admission group")
        if len(group) > self.admission_cap:
            raise ValueError(f"admission group of {len(group)} exceeds "
                             f"the {self.admission_cap}-slot pool")
        for req in group:
            self._validate(req)
        uids = [r.uid for r in group]
        dupes = sorted({u for u in uids if uids.count(u) > 1} |
                       {u for u in uids if u in self._resident or u in self._ready})
        if dupes:
            raise ValueError(f"duplicate request uids: {dupes} "
                             "(results are keyed by uid)")
        self._ensure_pool()
        rec = GroupRecord(uids=tuple(uids), index=self._next_index,
                          variant="lm", bucket=self.cfg.max_slots,
                          size=len(group))
        self._next_index += 1
        self._open.append(rec)
        self._rec_left[rec.index] = len(group)
        for req in group:
            self._uid_rec[req.uid] = rec
            self._resident.add(req.uid)
        self._queue.extend(group)
        self._admit()
        return rec

    def drain_ready(self) -> dict[int, Result]:
        """Advance bounded work — one decode block, freed slots refilled —
        and return every finished result ``{uid: Result}``."""
        if self._queue or self._active():
            self._step()
        return self._take_ready()

    def drain_all(self) -> dict[int, Result]:
        """Serve queue + resident slots to completion and return all
        finished results ``{uid: Result}``."""
        while self._queue or self._active():
            self._step()
        return self._take_ready()

    # -- the offline loop ---------------------------------------------------

    def run(self, requests: Iterable[Request]) -> dict[int, Result]:
        """Serve all requests to completion; returns {uid: Result}.

        Submits admission groups of ``admission_cap`` (the first fills the
        pool, the rest queue), then ``drain_all``.  Appends a per-run record
        to ``self.runs`` ({requests, tokens, wall_time_s, warmup,
        tokens_per_s}); a run that met a new shape is ``warmup`` and stays
        out of the measured stats that ``tokens_per_s()`` reports."""
        reqs = list(requests)
        for req in reqs:  # fail fast, before any request is served
            self._validate(req)
        uids = [req.uid for req in reqs]
        if len(set(uids)) != len(uids):
            dupes = sorted({u for u in uids if uids.count(u) > 1})
            raise ValueError(f"duplicate request uids: {dupes} "
                             "(results are keyed by uid)")
        if self._open or self._queue or self._active() or self._ready:
            raise ValueError("engine has undrained in-flight requests "
                             "(call drain_all first)")
        self._cold_run = False
        tok0 = self.stats["tokens"]
        t_start = self.wall()
        cap = self.admission_cap
        for i in range(0, len(reqs), cap):
            self.submit(reqs[i: i + cap])
        results = self.drain_all()
        dt = self.wall() - t_start
        toks = self.stats["tokens"] - tok0
        self.stats["wall_time_s"] += dt
        kind = "warmup" if self._cold_run else "measured"
        self.stats[kind]["requests"] += len(results)
        self.stats[kind]["work"] += toks
        self.stats[kind]["wall_time_s"] += dt
        self.runs.append({
            "requests": len(results), "tokens": toks, "wall_time_s": dt,
            "warmup": self._cold_run,
            "tokens_per_s": toks / dt if dt else 0.0,
        })
        return results

    @property
    def last_run(self) -> dict | None:
        """Per-run stats record of the most recent ``run()``."""
        return self.runs[-1] if self.runs else None

    # -- convenience APIs ---------------------------------------------------

    def generate(self, prompts, max_new_tokens: int | None = None) -> np.ndarray:
        """Batch API: prompts (B, P) array or list of ragged 1-D arrays.
        Returns (B, max_new_tokens) int32, pad_id-filled after EOS."""
        cfg = self.cfg
        budget = max_new_tokens if max_new_tokens is not None else cfg.max_new_tokens
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        reqs = [Request(uid=i, prompt=p, max_new_tokens=budget)
                for i, p in enumerate(prompts)]
        results = self.run(reqs)
        out = np.full((len(prompts), budget), cfg.pad_id, np.int32)
        for uid, res in results.items():
            out[uid, : len(res.tokens)] = res.tokens
        return out

    def utilization(self) -> float:
        """Fraction of decode slot-steps spent on live requests."""
        if not self.stats["slot_steps"]:
            return 0.0
        return self.stats["active_slot_steps"] / self.stats["slot_steps"]

    def tokens_per_s(self) -> float:
        """Measured steady-state generation throughput (warmup runs
        excluded; the warmup totals when only warmup runs exist)."""
        return rt.measured_rate(self.stats)

    def reset_stats(self):
        """Zero the cumulative stats and per-run records (the set of shapes
        met survives)."""
        self.stats = _fresh_stats(self.cfg.max_slots)
        self.runs = []
