"""The comparison that decides ``correct``: served logits against the
reference, stream by stream and frame by frame.

A served frame agrees with the reference when every logit lies within
``RTOL`` times the magnitude sum of its terms (``merged |W|``) of the
reference's float64 value.  Float32 sums of at most a few hundred terms in
any order stay near 1e-6 of that sum, while one spike that differs moves a
logit by a whole FC weight, about a hundredth of it: ``RTOL`` lies between.

The program runs the recurrent state in float32, the reference in float64,
and a stream whose membrane potential falls within rounding of a threshold
may take the other side there; the two then run apart for the rest of the
stream (a spike flip, legitimate in any summation order).  The reference
marks where each stream first reaches such a tie (``model.py``), and a
frame is decided when its stream has not reached one yet.  So the number
compared is the share of decided frames that disagree,
``diverged_decided_pct``, held to a limit set from the readings of sound
runs and of the control (``PERF.md``); the share of all checked frames
that disagree, ``diverged_frames_pct``, is reported beside it.  A checked
stream whose logits did not come back, or came back with another shape,
counts as disagreeing in every frame.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference.model import Reference

RTOL = 1e-4  # of the magnitude sum of a logit's terms
ATOL = 1e-6  # for logits whose terms are all zero


def compare(ref: Reference, streams: list[np.ndarray], served: list, scale
            ) -> dict:
    """Hold ``served[i]`` ((T_i, fc_dim) float32 logits, or None) against
    the reference run of ``streams[i]``.  Returns the counts the check
    prints, the shares ``diverged_decided_pct`` and ``diverged_frames_pct``,
    and the reference's multiply-accumulates a frame
    (``macs_per_frame``)."""
    b = len(streams)
    n = ref.cfg["fc_dim"]
    good = [s is not None and np.shape(s) == (len(x), n)
            for s, x in zip(served, streams)]
    buf = np.zeros((b, n), np.float32)
    diverged = np.zeros(b, np.int64)
    decided = np.zeros(b, np.int64)  # frames before the stream's first tie
    diverged_decided = np.zeros(b, np.int64)
    frames = sum(len(x) for x in streams)
    macs = 0.0
    for t, live, logits, magnitude, step_macs in ref.frames(streams, scale):
        rows = [i for i in range(b) if t < len(streams[i])]
        for i in rows:
            if good[i]:
                buf[i] = served[i][t]
        got = torch.from_numpy(buf).to(logits.device, torch.float64)
        ok = ((got - logits).abs() <= RTOL * magnitude + ATOL).all(dim=1)
        ok = (ok & live).cpu().numpy()
        tied = ref.tied.cpu().numpy()
        for i in rows:
            bad = not (good[i] and ok[i])
            diverged[i] += bad
            if not tied[i]:
                decided[i] += 1
                diverged_decided[i] += bad
        macs += float(step_macs.sum())
    return {
        "checked_streams": b,
        "checked_frames": int(frames),
        "missing_streams": int(b - sum(good)),
        "diverged_streams": int((diverged > 0).sum()),
        "diverged_frames": int(diverged.sum()),
        "diverged_frames_pct": (100.0 * float(diverged.sum()) / frames
                                if frames else 100.0),
        "tied_streams": int((decided < [len(x) for x in streams]).sum()),
        "decided_frames": int(decided.sum()),
        "diverged_decided_pct": (100.0 * float(diverged_decided.sum())
                                 / decided.sum() if decided.sum() else 100.0),
        "macs_per_frame": macs / frames if frames else 0.0,
    }
