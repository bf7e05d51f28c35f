"""Deterministic batched serving session (Pot × decoding), after
``repro.serve.session``.

Model math runs through ``models.lm.decode_step`` over the cache
``models.lm.init_cache`` builds for any of the ten architectures (a
whisper session decodes against zero cross-attention rows, as the
reference's does); the *shared serving
state* — a paged metadata store of (page, row) entries, one page range
per decode slot, and its page versions — is managed as preordered
transactions: each decode step, every active slot's page-append is a
transaction sequenced by the round-robin sequencer over slots, and the
commits apply in place through the ordered paged-commit kernel
(``kernels/kv_commit.py``), stamping page versions with sequence
numbers.  Two replicas fed the same requests emit bitwise-identical
tokens and fingerprints whatever the order the requests arrived in.

As in the reference: every slot decodes each step (the batch is
``n_slots``) but only active slots commit and advance; a slot's page is
``slot * (max_seq // page_size) + pos // page_size``, so past
``max_seq`` it runs into the next slot's pages (and past the last page
it is dropped); greedy decoding takes the argmax over the padded vocab.

``prof`` (``SMOKE`` by default) goes to ``lm.decode_step`` and
``lm.prefill``: with a mesh in it every rank runs the session SPMD on
its shards (``params`` a rank's tree, ``lm.local_params``; the decode
cache its shard, ``lm.init_cache``), emits the same tokens, and holds
and commits the page metadata of its own slots (its block of the batch
over the data axes) through the ordered paged-commit kernel; the
fingerprint gathers the ranks' pages in slot order, the dense
session's value on every rank.
:meth:`Session.prefill` admits a prompt in every slot at once, a step
the reference's session does not have.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sequencer import RoundRobinSequencer
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.shardings import SMOKE, Profile, gather, place_of

META_WIDTH = 8   # float32 entries of one page row


@dataclasses.dataclass
class Session:
    cfg: ModelConfig
    params: dict
    n_slots: int
    max_seq: int
    page_size: int = 16
    device: str | torch.device = "cuda"
    prof: Profile = SMOKE

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.cache = lm.init_cache(self.cfg, self.n_slots, self.max_seq,
                                   self.device, prof=self.prof)
        # the slots whose pages this process holds and commits
        self.place = place_of(self.prof, (self.n_slots, 1))
        held = self.n_slots // self.place.n_batch
        self.first_slot = held * self.place.i_batch
        self.held_slots = held
        self.pos = np.zeros((self.n_slots,), np.int32)       # host copy
        self.tokens = torch.zeros((self.n_slots, 1), dtype=torch.int64,
                                  device=self.device)
        self.active = np.zeros((self.n_slots,), bool)
        self.seqr = RoundRobinSequencer(n_root_lanes=self.n_slots)
        # paged metadata store (shared state under Pot commit)
        n_pages = self.held_slots * (self.max_seq // self.page_size)
        self.page_meta = torch.zeros((n_pages, self.page_size, META_WIDTH),
                                     dtype=torch.float32, device=self.device)
        self.page_versions = torch.zeros((n_pages,), dtype=torch.int32,
                                         device=self.device)

    def _decode(self, params, cache, tokens, pos):
        return lm.decode_step(params, cache, tokens, pos, self.cfg,
                              self.prof)

    def add_request(self, slot: int, first_token: int) -> None:
        if self.active[slot]:
            raise ValueError(f"slot {slot} already holds a request")
        self.active[slot] = True
        self.tokens[slot, 0] = first_token
        self.pos[slot] = 0

    def prefill(self, prompts) -> np.ndarray:
        """Admit a prompt in every slot at once: ``prompts`` (n_slots, P)
        int through ``lm.prefill``, whose cache rows fill the first rows
        of each layer's cache (in place).  Every slot becomes active at
        position P with its greedy next token, which is returned; the
        prompt's rows commit no page metadata."""
        if self.active.any():
            raise ValueError("prefill admits every slot; some already "
                             "hold requests")
        prompts = torch.as_tensor(prompts, device=self.device)
        n, p = prompts.shape
        if n != self.n_slots or p > self.max_seq:
            raise ValueError(f"prompts of shape {(n, p)} for {self.n_slots} "
                             f"slots of max_seq {self.max_seq}")
        logits, cache = lm.prefill(self.params, prompts, self.cfg, self.prof,
                                   max_seq=self.max_seq)
        for dst, src in zip(self.cache, cache, strict=True):
            for name, t in src.items():
                dst[name][:, :t.shape[1]].copy_(t)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        self.tokens = nxt[:, None]
        self.pos[:] = p
        self.active[:] = True
        return nxt.cpu().numpy().astype(np.int32)

    def step(self) -> np.ndarray:
        """One decode round: model math + ordered page-commit of every
        active slot's new row.  Returns the emitted tokens (greedy)."""
        pos = torch.from_numpy(self.pos).to(self.device)
        logits, self.cache = self._decode(self.params, self.cache,
                                          self.tokens, pos)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt_host = nxt.cpu().numpy().astype(np.int32)

        # ---- Pot commit of page metadata, in sequencer order, in place
        # (of the slots this process holds)
        active = [s for s in range(self.n_slots) if self.active[s]]
        order = np.asarray(self.seqr.order_for(active)) if active else None
        mine = [i for i, s in enumerate(active)
                if 0 <= s - self.first_slot < self.held_slots]
        if mine:
            slots = [active[i] for i in mine]
            n = len(slots)
            at = self.pos[slots]
            # page_idx, row_idx, sn and commit (int32), then the rows'
            # float32 bits: one buffer, one copy to the device
            host = np.empty((4 + META_WIDTH) * n, np.int32)
            meta = host[:4 * n].reshape(4, n)
            meta[0] = ((np.asarray(slots) - self.first_slot)
                       * (self.max_seq // self.page_size)
                       + at // self.page_size)
            meta[1] = at % self.page_size
            meta[2] = order[mine]
            meta[3] = 1
            host[4 * n:].view(np.float32).reshape(n, META_WIDTH)[:] = \
                nxt_host[slots, None]
            packed = torch.from_numpy(host)
            if self.device.type != "cpu":
                # pinned memory's allocator keeps the block until the
                # copy from it is done
                packed = packed.pin_memory().to(self.device,
                                                non_blocking=True)
            rows = packed[4 * n:].view(torch.float32).view(n, META_WIDTH)
            ops.kv_cache_commit_(self.page_meta, self.page_versions, rows,
                                 *packed[:4 * n].view(4, n))

        self.tokens = nxt[:, None]
        self.pos = self.pos + self.active.astype(np.int32)
        return nxt_host

    def generate(self, n_steps: int) -> np.ndarray:
        """Greedy-decode n_steps for all slots; (slots, n) tokens."""
        return np.stack([self.step() for _ in range(n_steps)], axis=1)

    def fingerprint(self) -> int:
        """Order-sensitive FNV-1a hash of every 97th byte of the versions
        (int32) and then of the metadata (float32), little-endian — the
        replica consistency check."""
        versions, meta = self.page_versions, self.page_meta
        for group, _, _ in reversed(self.place.batch):  # every rank's
            versions = gather(versions, group, 0)         # in slot order
            meta = gather(meta, group, 0)
        h = 0x811C9DC5
        for x in (versions.cpu().numpy().astype("<i4").tobytes(),
                  meta.cpu().numpy().astype("<f4").tobytes()):
            for chunk in x[::97]:
                h = ((h ^ chunk) * 0x01000193) & 0xFFFFFFFF
        return h
