"""Continuous-batching serving engine -- the paper's S2 fully-partitioned
state access pattern as a session store.

Port of ``repro/serving/engine.py``.  The stream of requests is the farm's
input stream; decode slots are the state partitions; the slot-assignment
policy is the hash ``h``:

* ``policy="hash"`` -- the paper's §4.2 scheme: session -> slot by hash; a
  collision (slot busy) queues the request.
* ``policy="ondemand"`` -- the next free slot (ideal balance).

``resize()`` changes the slot count online: active sessions' caches are
copied slot to slot (bit-exact, no re-prefill), planned by the port's
``keyed.store.plan_relocation``.  All decode slots advance in one batched
step with per-slot cache positions (ragged continuous batching), which the
decode attention kernel takes directly.

What differs from the reference, and why: there is no ``jit``, so prefill
and decode are plain calls of :mod:`repro_torch.models.transformer`; the
caches are updated IN PLACE (the decode step writes each slot's token into
its cache, the prefill writes the reusable one-slot cache, and admission
copies the prompt's KV rows and the whole recurrent state into the slot);
and each request keeps a copy of the logits its last token was taken from
(``Request.logits``), so a run can be checked against a reference without
recomputing it.  Because the one-slot cache is reused, its recurrent
(Mamba) leaves are zeroed before every prefill: the reference never
mutates its own, so each of its prefills starts from a zero conv history.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.keyed.store import hash_to_slot, plan_relocation
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [prompt_len] int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    #: float32 ``[vocab]`` logits the last generated token was taken from
    logits: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: T.Transformer,
        *,
        num_slots: int,
        s_max: int,
        policy: str = "ondemand",
        seed: int = 0,
        tracer=None,
        registry=None,
        device=None,
    ):
        if policy not in ("ondemand", "hash"):
            raise ValueError(f"policy must be 'ondemand' or 'hash', got "
                             f"{policy!r}")
        if num_slots <= 0 or s_max <= 1:
            raise ValueError(f"need num_slots >= 1 and s_max >= 2, got "
                             f"{num_slots} and {s_max}")
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params are on {params.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.seed = seed
        #: observability: prefill/decode/resize spans and latency histograms
        #: are no-ops unless a tracer/registry is supplied
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry
        self.num_slots = num_slots
        self.s_max = s_max
        self.policy = policy
        self.caches = self._new_caches(num_slots)
        self.lengths = np.zeros(num_slots, np.int32)      # valid cache length
        self.last_token = np.zeros(num_slots, np.int32)
        self.active: Dict[int, Request] = {}              # slot -> request
        self.waiting: Deque[Request] = collections.deque()
        self.steps = 0
        self.tokens_out = 0
        self.resize_events: List[dict] = []
        # reusable single-slot prefill cache: admitting a request prefills
        # into this buffer instead of allocating a fresh one-slot cache;
        # KV rows beyond the prompt hold stale values from earlier
        # admissions, which attention never reads (it stops at each slot's
        # length); recurrent leaves are zeroed before each prefill
        self._one_caches = self._new_caches(1)

    def _new_caches(self, n: int) -> T.Caches:
        return T.init_caches(self.cfg, n, self.s_max, self.cfg.cdtype,
                             device=self.device)

    # -- S2 slot assignment (the keyed store's hash, sessions as keys) ---------
    def _slot_for(self, req: Request) -> Optional[int]:
        if self.policy == "hash":
            slot = int(hash_to_slot(req.rid, self.num_slots))  # h(session)
            return slot if slot not in self.active else None
        for s in range(self.num_slots):
            if s not in self.active:
                return s
        return None

    # -- §4.2 adaptivity: online session-store resize --------------------------
    def resize(self, new_num_slots: int) -> int:
        """Change the decode-slot count online; returns sessions relocated.

        A new cache of ``new_num_slots`` partitions is allocated and every
        active session's cache is copied slot to slot (bit-exact -- no
        re-prefill, no dropped or reordered requests).  ``ondemand`` keeps
        slot ids that still fit and compacts the rest into free low slots;
        ``hash`` re-hashes sessions to the new modulus, and a session whose
        new slot collides with another is requeued (replayed exactly from
        prompt + generated at the next admit).  Shrinking below the number
        of active sessions requeues the overflow the same way.  Raises for a
        non-positive slot count."""
        if new_num_slots <= 0:
            raise ValueError(f"num_slots must be >= 1, got {new_num_slots}")
        if new_num_slots == self.num_slots:
            return 0
        with self.tracer.span("resize", n_old=self.num_slots,
                              n_new=new_num_slots):
            moved = self._resize_impl(new_num_slots)
        ev = self.resize_events[-1]
        self.tracer.instant(
            "resize", n_old=ev["old"], n_new=ev["new"],
            relocated=ev["relocated"], requeued=ev["requeued"],
        )
        return moved

    def _resize_impl(self, new_num_slots: int) -> int:
        old_active = dict(self.active)
        placements, requeued_slots = plan_relocation(
            {slot: req.rid for slot, req in old_active.items()},
            new_num_slots,
            policy=self.policy,
        )
        requeued = [old_active[slot] for slot in requeued_slots]

        new_caches = self._new_caches(new_num_slots)
        new_lengths = np.zeros(new_num_slots, np.int32)
        new_last = np.zeros(new_num_slots, np.int32)
        new_active: Dict[int, Request] = {}
        moved = 0
        for old_slot, new_slot in placements.items():
            for new, old in zip(new_caches, self.caches):
                for name in new:
                    new[name][new_slot].copy_(old[name][old_slot])
            req = old_active[old_slot]
            req.slot = new_slot
            new_active[new_slot] = req
            new_lengths[new_slot] = self.lengths[old_slot]
            new_last[new_slot] = self.last_token[old_slot]
            moved += int(new_slot != old_slot)
        for req in reversed(requeued):  # appendleft: reverse to keep order
            req.slot = None
            self.waiting.appendleft(req)  # ahead of new arrivals

        self.resize_events.append({
            "old": self.num_slots, "new": new_num_slots,
            "relocated": moved, "requeued": len(requeued),
        })
        self.num_slots = new_num_slots
        self.caches = new_caches
        self.lengths = new_lengths
        self.last_token = new_last
        self.active = new_active
        return moved

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _prefill(self, prefix: np.ndarray):
        tokens = torch.as_tensor(prefix, dtype=torch.int64,
                                 device=self.device)[None, :]
        T.zero_recurrent_(self._one_caches)
        logits, _ = T.prefill_forward(self.params, {"tokens": tokens},
                                      self.cfg, self._one_caches)
        return logits[0, -1]

    def _admit(self) -> None:
        still_waiting: Deque[Request] = collections.deque()
        while self.waiting:
            req = self.waiting.popleft()
            slot = self._slot_for(req)
            if slot is None:
                still_waiting.append(req)
                if self.policy == "ondemand":
                    still_waiting.extend(self.waiting)
                    break
                continue
            # prefill on a [1, prefix] batch into the one-slot cache, then
            # copy the prefix's rows into the slot.  The prefix includes any
            # already-generated tokens so a session requeued by a resize
            # replays exactly.
            prefix = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.generated, np.int32)]
            ) if req.generated else np.asarray(req.prompt, np.int32)
            plen = len(prefix)
            if plen >= self.s_max:
                raise ValueError(f"request {req.rid}: prefix of {plen} "
                                 f"tokens does not fit s_max {self.s_max}")
            t0 = self.tracer.clock.now()
            with self.tracer.span("prefill", rid=req.rid, plen=plen):
                logits = self._prefill(prefix)
                # int() waits for the card, so the span and the histogram
                # measure the whole prefill, not its launch
                first_tok = int(torch.argmax(logits))
            if self.registry is not None:
                self.registry.histogram("serving.prefill_s").record(
                    self.tracer.clock.now() - t0
                )
            req.generated.append(first_tok)
            req.logits = logits
            self.tokens_out += 1
            if req.done:
                # a requeued session can complete at the replay prefill
                # itself -- it must not occupy (and keep decoding in) a slot
                req.slot = None
                continue
            for big, one in zip(self.caches, self._one_caches):
                for name in big:
                    if name in T.KV_LEAVES:     # [B, Hkv, S_max, hd] rows
                        big[name][slot, :, :plen].copy_(
                            one[name][0, :, :plen])
                    else:                       # recurrent state, whole
                        big[name][slot].copy_(one[name][0])
            req.slot = slot
            self.active[slot] = req
            self.lengths[slot] = plen
            self.last_token[slot] = first_tok
        self.waiting = still_waiting

    def step(self) -> None:
        """One engine tick: admit waiting requests, decode all slots (the
        inactive ones too; their writes land inside ``s_max`` and are never
        read)."""
        self._admit()
        self.tracer.counter(
            "serving.load", active=len(self.active), waiting=len(self.waiting),
            slots=self.num_slots,
        )
        if not self.active:
            return
        t0 = self.tracer.clock.now()
        with self.tracer.span("decode", batch=len(self.active)):
            tokens = torch.as_tensor(self.last_token, dtype=torch.int64,
                                     device=self.device)[:, None]
            index = torch.as_tensor(self.lengths, dtype=torch.int32,
                                    device=self.device)
            logits, self.caches = T.decode_forward(
                self.params, {"tokens": tokens}, self.cfg, self.caches, index
            )
            logits = logits[:, -1]
            # the copy to the host waits for the card inside the span
            next_np = torch.argmax(logits, dim=-1).cpu().numpy()
        if self.registry is not None:
            self.registry.histogram("serving.decode_step_s").record(
                self.tracer.clock.now() - t0
            )
        self.steps += 1
        for slot, req in list(self.active.items()):
            self.lengths[slot] += 1
            req.generated.append(int(next_np[slot]))
            req.logits = logits[slot].clone()
            self.last_token[slot] = int(next_np[slot])
            self.tokens_out += 1
            if req.done or self.lengths[slot] >= self.s_max - 1:
                del self.active[slot]  # free the partition (S2 eviction)

    def run_to_completion(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.active and not self.waiting:
                return
            self.step()
        raise RuntimeError("engine did not drain")
