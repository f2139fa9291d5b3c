"""Operations and bytes of the work the per-layer metrics measure, and the
peaks they are held to.

The counts are of the work, not of an implementation: each input byte the
work needs is read once, each output byte written once, no recompute, and
where the work depends on the data (masked steps, repeated rows) only
what these inputs need is counted. Three ceilings: matrix products at the
fastest rate at which the card multiplies the configuration's operands,
other arithmetic at the card's float32 rate, bytes at its memory
bandwidth. The least time is the largest of the three times, so a share of
it over a measured time is at most 1 for any honest implementation.

Peaks: NVIDIA's data sheet for the H100 SXM5 (dense, without sparsity) at
its 700 W limit.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAKS = {
    "NVIDIA H100": {
        "matrix": {"float32": 495e12, "bfloat16": 989e12},  # TF32 and bf16 tensor-core rates
        "other": 67e12,  # float32 on the CUDA cores
        "bytes": 3.35e12,  # HBM3
    },
}

F32 = 4  # bytes
GATES = {"GRU": 3, "LSTM": 4}
# elementwise operations a unit and a valid step of the recurrence,
# forward and backward together (a sigmoid or tanh counted as one):
# GRU forward 11 (two gate adds and sigmoids, r*hid, add and tanh, the
# convex update, the mask) and twice that backward; LSTM forward 17
# (three peephole products and adds, three sigmoids, two tanh, the cell
# update, o*tanh(c'), two masks) and twice that backward
RECURRENCE_OPS = {"GRU": 33, "LSTM": 51}
# elementwise operations a logit: max, exp and sum in the forward; the
# softmax, the target's one-hot and the row weight in the backward
HEAD_OPS_PER_LOGIT = 6


def peaks(device_name: str) -> dict:
    for key, table in PEAKS.items():
        if device_name.startswith(key):
            return table
    raise KeyError(f"no peak table for {device_name!r}")


@dataclass
class Work:
    matrix_flops: float = 0.0
    other_flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.matrix_flops + other.matrix_flops, self.other_flops + other.other_flops,
                    self.bytes + other.bytes)

    def least_seconds(self, table: dict, precision: str) -> float:
        return max(self.matrix_flops / table["matrix"][precision], self.other_flops / table["other"],
                   self.bytes / table["bytes"])


def recurrence(cell: str, H: int, B: int, valid: int) -> Work:
    """One layer's time scan, forward and backward, over a batch of B rows
    with ``valid`` valid steps in all: the products h W_hid, their input
    cotangent and dW_hid (2 H GH flops a valid step each); reads x_pre
    and the cotangent dh, writes dx_pre at the valid steps, reads W_hid and
    writes dW_hid once, reads the initial states and writes their
    cotangents, the final state and the row lengths."""
    G = GATES[cell]
    n_states = 2 if cell == "LSTM" else 1
    n_peep = 3 * H if cell == "LSTM" else 0
    matrix = 3 * 2 * valid * H * G * H
    other = RECURRENCE_OPS[cell] * valid * H
    moved = (2 * valid * G * H  # x_pre in, dx_pre out
             + 2 * H * G * H + 2 * n_peep  # W_hid and peepholes in, their gradients out
             + 2 * n_states * B * H  # initial states in, their cotangents out
             + 2 * B * H  # final state out, its cotangent in
             + B)  # row lengths
    return Work(matrix, other, F32 * moved)


def cce_head(B: int, H: int, N: int) -> Work:
    """The CCE head over N items: logits h W_out (2 B H N), dh and dW_out
    (2 B H N each); reads h, W_out, b_out, the targets and the row
    weights, writes each row's cost, dh, dW_out and db_out."""
    moved = B * H + H * N + N + B + B  # inputs
    moved += B + B * H + H * N + N  # outputs
    return Work(6 * B * H * N, HEAD_OPS_PER_LOGIT * B * N, F32 * moved)


def gather_sum(D: int, valid: int, unique_rows: int) -> Work:
    """The one-hot input product W_in[ids] and its transpose at F = 1 over
    ``valid`` valid slots naming ``unique_rows`` distinct rows: reads the
    ids and the rows, writes the [valid, D] sums; reads their cotangent and
    writes the gradient rows that are touched, summing repeated ids."""
    moved = 2 * valid + 2 * unique_rows * D + 2 * valid * D
    return Work(0.0, (valid - unique_rows) * D, F32 * moved)


def model_flops_per_sequence(cell: str, steps: float, H: int, N: int) -> float:
    """Matrix flops a training sequence of ``steps`` valid steps (a mean
    over a batch may be fractional), forward and backward: 6 steps H G H in
    the recurrence and 6 H N in the output layer. Masked padding is no
    work."""
    return 6 * steps * H * GATES[cell] * H + 6 * H * N
