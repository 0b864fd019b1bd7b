"""The fixed peaks of one NVIDIA H100 SXM at its full 700 W power limit
(NVIDIA's data sheet, dense), and a call's least time under them.

Operations outside the tensor cores are counted as instructions, one per
lane for a fused multiply-add, a multiply, an add, a compare or a select,
at 132 SMs x 128 lanes x 1.98 GHz, the card's top SM clock: 3.345e13 a
second, the data sheet's 67 TFLOP/s float32 with a fused multiply-add
counted as its two FLOPs. These do not move with the clock a run reads."""

HBM_BYTES_S = 3.35e12
BF16_TC_FLOP_S = 989e12
INSTR_S = 132 * 128 * 1.98e9


def bound_s(n_bytes: float, ops: float, rate: float = INSTR_S) -> float:
    """Seconds a call moving n_bytes (each input read once, each output
    written once) and doing ops operations at rate a second needs at
    least."""
    return max(n_bytes / HBM_BYTES_S, ops / rate)

