"""Exact chunked CodeHiFiGAN synthesis for streaming S2ST.

Port of ``mm_s2ut/infer/streaming_vocoder.py``. Committed units go in
incrementally; waveform samples come out incrementally, equal to one
exact-length offline ``CodeHiFiGAN.forward`` over the final units.

Every op of the generator is translation-invariant in the interior
(same-padded convs, transposed convs with a symmetric trim), so output
sample s depends only on frames within ``generator_halo_samples(cfg)`` of
it. The session runs the generator on fixed-width frame windows
(``emit_frames + 2·halo``) and emits only their interior; at the true
signal edges the window is pinned to the edge, where the generator's own
padding applies. The duration predictor (two k = 3 convs) has its own
±2-unit halo, so a unit's duration is committed once two more units have
arrived (all of them at ``finalize``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from mm_s2ut_torch.models.hifigan import CodeHiFiGAN, HiFiGANConfig


def generator_halo_samples(cfg: HiFiGANConfig) -> int:
    """Upper bound on the generator's one-sided receptive field in output
    samples: through conv_pre, each upsample stage (×rate, + kernel), that
    stage's widest MRF branch, and conv_post."""
    h = 3  # conv_pre, kernel 7 same-padded
    for rate, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        h = h * rate + k
        mrf = 0
        for ks, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            mrf = max(mrf, sum((ks - 1) * d // 2 + (ks - 1) // 2 for d in dils))
        h += mrf
    return h + 3  # conv_post, kernel 7


class StreamingVocoderSession:
    """Incremental unit → wav synthesis on the vocoder's device.

    ``feed(units)`` appends committed units and returns any newly mature
    samples (a float32 array); ``finalize()`` flushes the rest. All the
    returned chunks together equal ``CodeHiFiGAN.forward`` on the whole
    sequence with an exact-length frame budget."""

    def __init__(self, vocoder: CodeHiFiGAN, *, emit_frames: int = 64, max_units: int = 1024):
        cfg = vocoder.cfg
        self.vocoder = vocoder
        self.device = vocoder.dict.weight.device
        self.hop = cfg.hop_length
        self.halo_f = -(-generator_halo_samples(cfg) // self.hop)  # ceil
        self.emit_frames = emit_frames
        self.W = emit_frames + 2 * self.halo_f
        self.max_units = max_units
        # The duration predictor's two k-size convs see ±(k-1)//2 units each.
        self.dur_halo = 2 * ((cfg.var_pred_kernel_size - 1) // 2) if cfg.dur_prediction else 0
        self.units: List[int] = []
        self.dur_done = 0  # units with committed durations
        self.frame_units = np.zeros((0,), np.int64)  # frame → unit id
        self.emitted_f = 0  # frames whose samples were emitted

    def _commit_durations(self, upto: int) -> None:
        """Durations of units [dur_done, upto), whose ±halo context has
        arrived, extend the frame-level unit sequence."""
        if upto <= self.dur_done:
            return
        if len(self.units) > self.max_units:
            raise ValueError("stream exceeds max_units")
        units = torch.tensor([self.units], dtype=torch.long, device=self.device)
        dur = self.vocoder.unit_durations(units)[0].cpu().numpy()
        new = [np.full((int(dur[u]),), self.units[u], np.int64) for u in range(self.dur_done, upto)]
        self.frame_units = np.concatenate([self.frame_units, *new])
        self.dur_done = upto

    def _run_window(self, w0: int, w1: int, e0: int, e1: int) -> np.ndarray:
        """Generator over frames [w0, w1); the samples of frames [e0, e1).
        Mid-stream the frame buffer may not reach w1 yet: the slice is
        zero-padded to the window width, and the pad starts at ≥ e1 + halo,
        so its phantom activations never reach the emitted interior."""
        fu = np.zeros((w1 - w0,), np.int64)
        seg = self.frame_units[w0:w1]
        fu[: seg.shape[0]] = seg
        wav = self.vocoder.vocode_frames(torch.from_numpy(fu[None]).to(self.device))[0]
        return wav[(e0 - w0) * self.hop : (e1 - w0) * self.hop].float().cpu().numpy()

    def _emit_ready(self, total_f: int) -> List[np.ndarray]:
        """Emit the interior blocks whose right halo has arrived."""
        out = []
        while self.emitted_f + self.emit_frames + self.halo_f <= total_f:
            e0 = self.emitted_f
            e1 = e0 + self.emit_frames
            w0 = max(0, e0 - self.halo_f)
            out.append(self._run_window(w0, w0 + self.W, e0, e1))
            self.emitted_f = e1
        return out

    def feed(self, units: List[int]) -> np.ndarray:
        """Append committed units; returns newly mature samples (may be
        empty), final: exactly the offline wav's."""
        self.units += [int(u) for u in units]
        self._commit_durations(max(self.dur_done, len(self.units) - self.dur_halo))
        chunks = self._emit_ready(len(self.frame_units))
        return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)

    def finalize(self) -> np.ndarray:
        """Flush: the remaining durations commit (the right edge is real)
        and the tail window is pinned to the true signal edge."""
        self._commit_durations(len(self.units))
        total = len(self.frame_units)
        out = self._emit_ready(total)
        if self.emitted_f < total:
            # A stream shorter than one window is one exact-length run;
            # otherwise the steady window is pinned to the right edge.
            w0 = 0 if total <= self.W else total - self.W
            out.append(self._run_window(w0, total, self.emitted_f, total))
            self.emitted_f = total
        return np.concatenate(out) if out else np.zeros((0,), np.float32)
