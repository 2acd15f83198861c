"""The yardstick of the kernels: peaks, and K6's bytes and operations.

K6 is the port's single-launch frame step (``kernels/megastep.py`` over
``csrc/megastep.cu``): one launch advances every slot of the loop by a
chunk of F frames, both recurrent layers, the merged-spike FC readout and
the sparsity counters.  Its least time is the larger of its bytes over the
card's memory bandwidth and its operations over the peak rate of the
arithmetic the configuration needs:

* bytes: each input of a launch read once and each output written once,
  at the launch's interface (``launch_bytes``).  The (F, B, fc_dim)
  float32 logits dominate.
* operations: 2 per multiply-accumulate that the frames' inputs need at
  the stored nonzero weights: the nonzero 8-bit inputs and the spikes,
  each times the nonzero weights of its row (the zero-skipping dataflow),
  counted by the benchmark's own reference over the streams it checks,
  never by the program.  No other kernel computing the same frame moves
  this count.
* peaks (NVIDIA H100 SXM data sheet, dense): 3.35 TB/s of HBM3; int8 at
  1,979 TOP/s for the int4 model (8-bit inputs, spikes and int4 weights
  are exact on the int8 tensor cores); float32 at 67 TFLOP/s outside the
  tensor cores for the float32 model (TF32 would round its weights).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int4": 1979e12, "float32": 67e12}
F32 = 4


def weight_bytes(cfg: dict, fc_entries: int) -> int:
    """Bytes of the four layer weights and the FC as K6 takes them: int4
    nibbles (K/2, H) with float32 scales and the padded CSC FC (int32
    indices and float32 values, ``fc_entries`` a column, float32 scales);
    or float32 matrices."""
    d, h, n = cfg["input_dim"], cfg["hidden_dim"], cfg["fc_dim"]
    if cfg["precision"] == "int4":
        layers = (d // 2 + 3 * (h // 2)) * h + 4 * h * F32
        if cfg["fc_layout"] != "csc":
            raise ValueError(f"no byte count for fc_layout "
                             f"{cfg['fc_layout']!r}")
        return layers + fc_entries * n * (4 + F32) + n * F32
    return ((d + 3 * h) * h + h * n) * F32


def launch_bytes(cfg: dict, slots: int, frames: int, fc_entries: int) -> int:
    """Bytes one K6 launch over ``slots`` slots and a chunk of ``frames``
    frames reads and writes, each operand once: the quantized frames, the
    carried state in and out (TS spike trains and the membrane and last
    spike of each layer), the LIF constants, the weights, the logits and
    the four counters."""
    d, h, n, ts = (cfg["input_dim"], cfg["hidden_dim"], cfg["fc_dim"],
                   cfg["num_ts"])
    f, b = frames, slots
    state = (2 * ts * b * h + 4 * b * h) * F32
    inputs = f * b * d * F32 + state + 4 * h * F32 + weight_bytes(
        cfg, fc_entries)
    outputs = ((2 * ts * b * h + 2 * b * h) * F32 + f * b * n * F32
               + (2 * f * ts * b + 2 * f * b) * F32)
    return inputs + outputs


def roofline_seconds(cfg: dict, launches: int, bytes_per_launch: int,
                     ops: float) -> float:
    """The least time of ``launches`` launches that move
    ``bytes_per_launch`` each and do ``ops`` operations in all."""
    return max(launches * bytes_per_launch / HBM_BYTES_PER_S,
               ops / PEAK_OPS_PER_S[cfg["precision"]])
