"""Quickstart: the SC datapath end to end at the bit level.

Walks one neuron through the paper's pipeline: thermometer coding
(Table II), ternary multipliers (Fig 3a), BSN accumulation and the SI
activation (Fig 3b), BN fusion (Eq 1), and shows that three views agree:
the bit-exact circuit, the integer datapath and the quantized float
math.  On the card the BSN sort runs the ``bsn_sort`` kernel and the
last step the ``ternary_matmul`` kernel.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Port of ``examples/quickstart.py``; the neuron's levels are the same
``jax.random`` draws (``repro_torch.prng``).
"""

from __future__ import annotations

import argparse

import torch

from .. import prng
from ..core import bsn, coding, multiplier, si
from ..device import resolve_device
from ..kernels import ops


def bits_str(b: torch.Tensor) -> str:
    return "".join(str(int(x)) for x in b.reshape(-1).tolist())


def run(device: str | torch.device | None = None) -> dict:
    """Print the walk-through; return the neuron's integers: the BSN sum,
    the integer dot, the kernel's sum and the SI output level."""
    dev = resolve_device(device)
    print("=== 1. Thermometer coding (Table II) ===")
    for bsl in (2, 4, 8):
        half = bsl // 2
        codes = [bits_str(coding.encode_thermometer(
            torch.tensor(v, device=dev), bsl)) for v in range(-half, half + 1)]
        print(f"  BSL {bsl}: {dict(zip(range(-half, half + 1), codes))}")

    print("\n=== 2. Ternary multiplier (Fig 3a), all 9 cases ===")
    for a in (-1, 0, 1):
        row = []
        for w in (-1, 0, 1):
            p = multiplier.ternary_mul_bits(
                coding.encode_thermometer(torch.tensor(a, device=dev), 2),
                coding.encode_thermometer(torch.tensor(w, device=dev), 2))
            row.append(f"{a}x{w}={bits_str(p)}"
                       f"({int(coding.decode_thermometer(p))})")
        print("  " + "  ".join(row))

    print("\n=== 3. One neuron: multiply -> BSN sort -> SI ReLU ===")
    alpha = 0.5
    a_q = prng.randint(prng.key(0), (8,), -4, 5).to(dev)   # 8 inputs, BSL 8
    w_q = prng.randint(prng.key(1), (8,), -1, 2).to(dev)
    print(f"  activations (q): {a_q.tolist()}  weights: {w_q.tolist()}")
    a_bits = coding.encode_thermometer(a_q, 8)
    prods = multiplier.ternary_scale_bits(w_q, a_bits)     # wiring-level mul
    sorted_bits = bsn.exact_bsn_bits(prods)                # the BSN
    print(f"  sorted bitstream ({sorted_bits.shape[-1]}b): "
          f"{bits_str(sorted_bits)}")
    sum_q = int(coding.counts_from_bits(sorted_bits)) - 8 * 8 // 2
    dot = int(torch.sum(a_q * w_q))
    print(f"  accumulated sum_q = {sum_q}  (integer dot = {dot})")
    t = si.si_thresholds(si.relu_fn, 64, 16, alpha_in=alpha, alpha_out=alpha)
    out_bits = si.apply_si_bits(sorted_bits, t)
    out_q = int(out_bits.sum()) - 8
    print(f"  SI(ReLU) output code: {bits_str(out_bits)} -> value "
          f"{alpha * out_q:.2f} (float ref {max(0.0, alpha * sum_q):.2f})")

    print("\n=== 4. BN-fused ReLU thresholds (Eq 1 / Fig 7) ===")
    t_plain = si.si_thresholds(si.relu_fn, 64, 16, alpha, alpha)
    t_bn = si.si_thresholds(si.bn_relu_fn(gamma=2.0, beta=1.0), 64, 16,
                            alpha, alpha)
    print(f"  plain ReLU thresholds (bits 8-16): {t_plain[8:16]}")
    print(f"  BN-fused  thresholds (bits 8-16): {t_bn[8:16]}  "
          "(beta shifts, gamma re-spaces: no extra hardware)")

    print("\n=== 5. The same neuron through ops.ternary_matmul (the kernel "
          "on the card, its plain version on the CPU) ===")
    out = ops.ternary_matmul(a_q[None, :].to(torch.int8),
                             w_q[:, None].to(torch.int8))
    kernel = int(out[0, 0])
    print(f"  ternary_matmul -> {kernel} (== BSN popcount: {sum_q}) on "
          f"{dev}")
    print("\nAll three views agree. See repro_torch.examples.serve_sc for a "
          "whole network on the integer datapath.")
    if not sum_q == dot == kernel:
        raise AssertionError(f"BSN {sum_q}, dot {dot}, kernel {kernel}")
    return {"sum_q": sum_q, "dot": dot, "kernel": kernel, "si_q": out_q,
            "sorted_bits": bits_str(sorted_bits)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
