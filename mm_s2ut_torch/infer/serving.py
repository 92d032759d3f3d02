"""Continuous-batching beam-decode server of the port.

Port of ``mm_s2ut/infer/serving.py`` (``Request``, ``Result``,
``ContinuousServer``): the decode batch is a pool of SLOTS, each holding
one utterance's K beams. When an utterance finishes, its slot is refilled
from the request queue at the next chunk boundary while the other slots
keep decoding.

* The self-attention cache keeps the offline layout (B, L, H, T·K, 2·Dh),
  but its step axis is a RING of T steps: every slot writes its rows at
  ring step g mod T (g the global step counter, a host int), while each
  slot's logical time is its own ``local_step``. Validity and ancestry
  reach kernels B, D and F only through ``flat_rep``
  (``UnitDecoder.serve_step``), so admission rewrites no cache row.
* Admission runs between chunks: a wave of up to ``admit_width`` requests
  is encoded once (kernel A), its cross K/V re-derived at the server's
  ``kv_cache_dtype`` (int8 slab and scales for an int8 or int4 cache) and
  scattered into the admitted slots, whose search state is reset.
* A chunk is ``chunk`` decode steps with the offline search's per-slot
  rules (``infer/beam_search.py``: the two-stage top-2K with ties to the
  lower index, EOS forced at the slot's budget, length-normalised
  finished scores, the improvability test). A done slot freezes itself on
  the device; the chunk ends in ONE packed (B, ring + 2) int32 report
  [best finished row | finished | score bits].
* ``run`` is double-buffered: chunk N+1 is dispatched before the host
  waits on chunk N's report, which was copied into a pinned host buffer
  behind an event. That wait is the one host sync per chunk; no step
  syncs. A per-slot generation counter keeps a stale report from emitting
  a refilled slot.

Results equal the offline ``beam_search`` per utterance (the per-step
selection is its ``select_beams``): chunking and slot sharing change the
schedule, and the arithmetic only by the rounding of batched products,
which a requantizing int4 cache can carry to ~1e-4 in a score. The device
is the model's; the vocabulary is the model's, the image sources are
``img_shapes``. With ``enc_feat_dim=None`` the model reads raw waveforms
(the XM model, or a wav2vec2/HuBERT ``speech_encoder_type``): a request is
then a (T,) waveform and ``enc_frames`` counts samples, and a slot's
budget counts the model's frames, ⌈samples / ``source_downsample_ratio``⌉,
as the offline generator does (the reference's server takes a·samples + b,
which with a > 0 always reaches the ring's limit). Not carried over: the
reference's ``sync_every`` (a workaround for its TPU relay).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from mm_s2ut_torch.infer.beam_search import NEG_INF, _length_norm, _take, select_beams


@dataclasses.dataclass
class Request:
    """One utterance to decode: ``features`` (T, F) log-mels, or a (T,)
    waveform for a raw-waveform server, and their ``length``;
    ``imgs``/``img_masks`` the optional image sources."""

    uid: Any
    features: np.ndarray
    length: int
    imgs: Tuple[np.ndarray, ...] = ()
    img_masks: Tuple[np.ndarray, ...] = ()


@dataclasses.dataclass
class Result:
    uid: Any
    tokens: List[int]  # best hypothesis, BOS stripped, cut at EOS
    score: float


class ContinuousServer:
    """Slot-pool beam-decode server around an ``MMS2UTModel`` or an
    ``MMXMTransformerModel`` (eval mode, on its device). ``run(requests)``
    returns one :class:`Result` per request, in completion order; ``stats``
    then holds the last run's host phases (seconds) and counts."""

    def __init__(
        self,
        model,
        *,
        slots: int = 8,
        beam_size: int = 5,
        ring: int = 256,
        chunk: int = 16,
        enc_frames: int = 1024,
        eos_id: int = 2,
        bos_id: int = 2,
        pad_id: int = 1,
        len_penalty: float = 1.0,
        max_len_a: float = 1.0,
        max_len_b: int = 200,
        img_shapes: Tuple[Tuple[int, int], ...] = (),
        kv_cache_dtype: str = "bfloat16",
        admit_width: Optional[int] = None,
        enc_feat_dim: Optional[int] = 80,
    ):
        self.ratio = model.source_downsample_ratio
        feat_dim = (None if model.reads_waveform else
                    model.cfg.input_feat_per_channel * model.cfg.input_channels)
        if enc_feat_dim != feat_dim:
            raise ValueError(f"enc_feat_dim {enc_feat_dim}: the model reads "
                             f"{'raw waveforms (None)' if feat_dim is None else feat_dim}")
        if max_len_b >= ring:
            raise ValueError("ring must exceed max_len_b (no wrap within one utterance)")
        if kv_cache_dtype == "int4":
            ring += ring % 2  # the half-split nibble layout needs an even ring
        self.model = model
        self.device = model.device
        self.B, self.K = slots, beam_size
        self.ring, self.chunk = ring, chunk
        self.enc_frames, self.enc_feat_dim = enc_frames, enc_feat_dim
        self.eos, self.bos, self.pad = eos_id, bos_id, pad_id
        self.V = model.decoder.embed.embed_tokens.num_embeddings
        self.len_penalty = len_penalty
        self.max_len_a, self.max_len_b = max_len_a, max_len_b
        self.img_shapes = tuple(img_shapes)
        self.kv_cache_dtype = kv_cache_dtype
        # Admission width: a wave encodes and ships this many rows, so the
        # host-to-device traffic scales with the refills, not the pool.
        self.A = min(slots, admit_width) if admit_width else slots
        self.stats: Dict[str, float] = {}

    # -- device state ----------------------------------------------------------

    def _full(self, shape, value, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)

    @torch.no_grad()
    def init_state(self) -> Dict[str, Any]:
        """All-idle server state: cross caches sized by one encode of zero
        features, the self cache tiled to ring·K columns, per-slot search
        state. ``g`` is a host int."""
        B, K, T = self.B, self.K, self.ring
        feats = torch.zeros(self._src_shape(B), device=self.device)
        lengths = torch.full((B,), self.enc_frames, dtype=torch.long, device=self.device)
        imgs = [torch.zeros((B, t, d), device=self.device) for t, d in self.img_shapes]
        masks = [torch.zeros((B, t), dtype=torch.bool, device=self.device)
                 for t, _ in self.img_shapes]
        enc = self.model.encode(feats, lengths, imgs, masks)
        dec = self.model.decode_init(enc, T, kv_dtype=self.kv_cache_dtype)
        state = {key: dec[key] for key in ("cross", "cross_bias")}
        for key in ("self_kv", "self_kv_sk", "self_kv_sv"):
            if key in dec:
                shape = list(dec[key].shape)
                shape[3] *= K  # int4: the packed axis, T/2 per slot
                state[key] = torch.zeros(shape, dtype=dec[key].dtype, device=self.device)
        long, f32 = torch.long, torch.float32
        state.update(
            ancestry=self._full((B, K, T), 0, long),
            g=0,
            local_step=self._full((B,), 0, long),
            ring_base=self._full((B,), 0, long),
            alive_seq=self._full((B, K, T), self.pad, long),
            alive_logp=self._full((B, K), NEG_INF, f32),
            fin_seq=self._full((B, K, T), self.pad, long),
            fin_scores=self._full((B, K), NEG_INF, f32),
            fin_flags=self._full((B, K), False, torch.bool),
            slot_max=self._full((B,), 0, long),
            active=self._full((B,), False, torch.bool),
            # Set when a slot freezes, cleared on admission: a report read
            # a chunk late still names every finisher not yet claimed.
            finished=self._full((B,), False, torch.bool),
        )
        return state

    def _src_shape(self, n: int) -> Tuple[int, ...]:
        """(n, frames, features), or (n, samples) for raw waveforms."""
        if self.enc_feat_dim is None:
            return (n, self.enc_frames)
        return (n, self.enc_frames, self.enc_feat_dim)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """Host array → device tensor without a host sync: through a fresh
        pinned buffer on the card (a later wave's fill can never alias a
        copy still in flight), as is on the CPU."""
        t = torch.from_numpy(array)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    @torch.no_grad()
    def _encode(self, wave: Dict[str, Any]) -> Dict[str, Any]:
        """The wave's encoder states and its cross caches at the server's
        ``kv_cache_dtype`` (kernel A in the encoder)."""
        enc = self.model.encode(wave["feats"], wave["lens"], wave["imgs"], wave["masks"])
        return self.model.decoder.init_cross(
            enc["encoder_out"], enc["encoder_padding_mask"], self.kv_cache_dtype)

    @torch.no_grad()
    def _admit(self, state: Dict[str, Any], cross: Dict[str, Any], rows: List[int],
               slots: List[int], budgets: np.ndarray) -> None:
        """Scatter wave rows ``rows`` of ``cross`` into ``slots`` and reset
        those slots' search state, in place (the writes follow the chunk in
        flight on the stream). The self cache is untouched: the fresh
        ``ring_base`` and ``local_step`` = 0 leave none of its columns live."""
        K, T = self.K, self.ring
        idx = self._to_device(np.asarray(slots, np.int64))
        src = self._to_device(np.asarray(rows, np.int64))
        for old, new in zip(state["cross"], cross["cross"]):
            for key in old:  # the slab, and the int8 scales with it
                old[key].index_copy_(0, idx, new[key].index_select(0, src))
        if state["cross_bias"] is not None:
            state["cross_bias"].index_copy_(0, idx, cross["cross_bias"].index_select(0, src))
        n = len(slots)
        seq0 = self._full((n, K, T), self.pad, torch.long)
        seq0[:, :, 0] = self.bos
        logp0 = self._full((n, K), NEG_INF, torch.float32)
        logp0[:, 0] = 0.0
        resets = {
            "ancestry": 0, "local_step": 0, "ring_base": state["g"] % T,
            "alive_seq": seq0, "alive_logp": logp0, "fin_seq": self.pad,
            "fin_scores": NEG_INF, "fin_flags": False, "active": True, "finished": False,
        }
        for key, value in resets.items():
            if isinstance(value, torch.Tensor):
                state[key].index_copy_(0, idx, value)
            else:
                state[key].index_fill_(0, idx, value)
        state["slot_max"].index_copy_(0, idx, self._to_device(budgets))

    def _budgets(self, lengths: np.ndarray) -> np.ndarray:
        """Each slot's step budget from its RAW source frames (the offline
        generator's rule; the encoder's mask is subsampled; a waveform's
        frames are ⌈samples / ratio⌉), in fp32 as the reference computes
        it, at most ring − 2."""
        frames = -(-lengths // self.ratio)
        raw = np.float32(self.max_len_a) * frames.astype(np.float32) + np.float32(self.max_len_b)
        return np.minimum(raw.astype(np.int64), self.ring - 2)

    @torch.no_grad()
    def _decode_chunk(self, state: Dict[str, Any]) -> torch.Tensor:
        """``chunk`` decode steps with per-slot beam-search rules, then the
        done test, self-freezing and the packed (B, ring + 2) int32 report."""
        B, K, V, T = self.B, self.K, self.V, self.ring
        eos_only = self._full((V,), NEG_INF, torch.float32)
        eos_only[self.eos] = 0.0
        for _ in range(self.chunk):
            local = state["local_step"]
            prev_tok = torch.gather(state["alive_seq"], 2, local[:, None, None].expand(B, K, 1))
            logits, state = self.model.serve_step(prev_tok.reshape(B * K, 1), state)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            at_budget = (local + 1) >= state["slot_max"]  # forced EOS
            logp = torch.where(at_budget[:, None, None], eos_only, logp)

            (state["alive_logp"], state["alive_seq"], state["fin_scores"], state["fin_seq"],
             state["fin_flags"], src_beam) = select_beams(
                logp, state["alive_logp"], state["alive_seq"], state["fin_seq"],
                state["fin_scores"], state["fin_flags"], (local + 1)[:, None, None],
                _length_norm(local + 1, self.len_penalty)[:, None], self.eos,
                state["active"][:, None])
            # The ancestry at the ring step just written (serve_step has
            # advanced g past it).
            anc = _take(state["ancestry"], src_beam)
            anc[:, :, (state["g"] - 1) % T] = src_beam
            state["ancestry"] = anc

        # A slot is done when all K finished and no alive beam can beat the
        # worst finished one (the offline rule), or past its budget.
        best_alive = state["alive_logp"][:, 0] / _length_norm(state["slot_max"], self.len_penalty)
        worst_fin = torch.where(state["fin_flags"], state["fin_scores"],
                                torch.full_like(state["fin_scores"], NEG_INF)).amin(1)
        done = state["active"] & (
            (state["fin_flags"].all(1) & (best_alive <= worst_fin))
            | (state["local_step"] >= state["slot_max"] + 1))
        state["active"] = state["active"] & ~done
        state["finished"] = state["finished"] | done
        state["alive_logp"] = torch.where(done[:, None], torch.full_like(state["alive_logp"], NEG_INF),
                                          state["alive_logp"])
        score_bits = state["fin_scores"][:, :1].contiguous().view(torch.int32)
        return torch.cat([state["fin_seq"][:, 0].int(), state["finished"][:, None].int(),
                          score_bits], dim=1)

    # -- host loop -------------------------------------------------------------

    @torch.no_grad()
    def run(self, requests: Iterable[Request]) -> List[Result]:
        """Serve ``requests`` to the end: admission waves between chunks,
        chunk N+1 dispatched before chunk N's report is read."""
        queue = list(requests)
        queue.reverse()  # pop from the end
        results: List[Result] = []
        self.stats = {"stage_s": 0.0, "admit_s": 0.0, "decode_s": 0.0, "drain_s": 0.0,
                      "waves": 0, "chunks": 0}
        state = self.init_state()
        slot_uid: List[Optional[Any]] = [None] * self.B
        gen = [0] * self.B  # bumped on every admission into the slot
        A, T, cuda = self.A, self.ring, self.device.type == "cuda"

        def stage_next() -> Optional[Dict[str, Any]]:
            """Pop the next ≤ A requests into fresh host buffers and start
            their copy to the device; the wave is encoded when it is first
            admitted."""
            if not queue:
                return None
            feats = np.zeros(self._src_shape(A), np.float32)
            lens = np.zeros((A,), np.int64)
            imgs = [np.zeros((A, t, d), np.float32) for t, d in self.img_shapes]
            masks = [np.ones((A, t), bool) for t, _ in self.img_shapes]
            reqs = []
            for a in range(A):
                if not queue:
                    break
                req = queue.pop()
                reqs.append(req)
                n = min(req.features.shape[0], self.enc_frames)
                feats[a, :n] = req.features[:n]
                lens[a] = min(req.length, self.enc_frames)
                for i, (t, _) in enumerate(self.img_shapes):
                    if i < len(req.imgs):
                        ti = min(req.imgs[i].shape[0], t)
                        imgs[i][a, :ti] = req.imgs[i][:ti]
                        masks[i][a, :ti] = req.img_masks[i][:ti] if i < len(req.img_masks) else False
            return {
                "reqs": reqs, "admitted": 0, "cross": None, "budgets": self._budgets(lens),
                "feats": self._to_device(feats), "lens": self._to_device(lens),
                "imgs": [self._to_device(x) for x in imgs],
                "masks": [self._to_device(x) for x in masks],
            }

        def admit_waves(staged):
            while staged is not None:
                reqs = staged["reqs"]
                free = [b for b in range(self.B) if slot_uid[b] is None]
                if not free:
                    break
                rows, slots = [], []
                for a in range(staged["admitted"], len(reqs)):
                    if not free:
                        break
                    b = free.pop(0)
                    slot_uid[b] = reqs[a].uid
                    gen[b] += 1
                    rows.append(a)
                    slots.append(b)
                staged["admitted"] = rows[-1] + 1
                t0 = time.perf_counter()
                if staged["cross"] is None:
                    staged["cross"] = self._encode(staged)
                self._admit(state, staged["cross"], rows, slots, staged["budgets"][rows])
                self.stats["admit_s"] += time.perf_counter() - t0
                self.stats["waves"] += 1
                if staged["admitted"] < len(reqs):
                    break  # a partial wave: the rest waits for free slots
                t0 = time.perf_counter()
                staged = stage_next()
                self.stats["stage_s"] += time.perf_counter() - t0
            return staged

        def drain(report: torch.Tensor, event, dispatch_gen: List[int]) -> None:
            """Wait for a chunk's report and emit its finishers."""
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            packed = report.numpy()
            self.stats["drain_s"] += time.perf_counter() - t0
            done = packed[:, T] != 0
            scores = packed[:, T + 1].view(np.float32)
            for b in np.nonzero(done)[0]:
                if slot_uid[b] is None or dispatch_gen[b] != gen[b]:
                    continue  # already emitted, or the slot has been refilled since
                toks = [int(t) for t in packed[b, 1:T]]  # strip BOS
                if self.eos in toks:
                    toks = toks[: toks.index(self.eos)]
                results.append(Result(slot_uid[b], toks, float(scores[b])))
                slot_uid[b] = None

        # Two pinned report buffers: chunk N's is read while chunk N+1's
        # copy is queued behind chunk N+1.
        host = [torch.empty((self.B, T + 2), dtype=torch.int32, pin_memory=cuda) for _ in range(2)]
        t0 = time.perf_counter()
        staged = stage_next()
        self.stats["stage_s"] += time.perf_counter() - t0
        inflight = None
        while queue or staged is not None or any(u is not None for u in slot_uid):
            staged = admit_waves(staged)
            t0 = time.perf_counter()
            report = self._decode_chunk(state)
            buf = host[self.stats["chunks"] % 2]
            buf.copy_(report, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            self.stats["decode_s"] += time.perf_counter() - t0
            self.stats["chunks"] += 1
            if inflight is not None:
                drain(*inflight)
            inflight = (buf, event, list(gen))
        if inflight is not None:
            drain(*inflight)
        self.stats["steps"] = state["g"]
        return results
