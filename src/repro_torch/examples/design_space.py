"""Approximate-BSN design-space exploration (paper Fig 10b / §IV).

Sweeps the parameterised BSN space (clip window x sampling stride x
temporal fold) for one accumulation width, measures each configuration's
MSE bit-exactly, prices it with the calibrated gate model
(``core/hwmodel.py``) and prints the ADP-vs-MSE Pareto front: the
co-design loop a hardware team would run per layer.  On the card the
spatial configurations run the ``approx_bsn`` kernel and the folded ones
the temporal adder's.

    PYTHONPATH=src python -m repro_torch.examples.design_space --width 4608

Port of ``examples/design_space.py``; the drawn products are the same
``jax.random.choice`` draws (``repro_torch.prng``).
"""

from __future__ import annotations

import argparse

import torch

from .. import prng
from ..core import hwmodel
from ..core.bsn import ApproxBSNSpec, StageSpec, SubSampleSpec, approx_bsn
from ..device import resolve_device

IN_BSL = 2


def draw(width: int, n: int = 2048, seed: int = 0,
         device: str | torch.device | None = None) -> torch.Tensor:
    """(n, width) ternary products, -1 / 0 / +1 with probabilities 0.16 /
    0.68 / 0.16 (int64)."""
    dev = resolve_device(device)
    return prng.choice(prng.key(seed).to(dev), torch.tensor([-1, 0, 1]),
                       (n, width), p=torch.tensor([0.16, 0.68, 0.16]))


def measure_mse(spec: ApproxBSNSpec, cycles: int, n: int = 2048,
                seed: int = 0,
                device: str | torch.device | None = None) -> float:
    """Mean squared error, per product, of the approximate sum against the
    exact one over ``n`` drawn rows."""
    width = spec.width * cycles
    vals = draw(width, n, seed, device)
    counts = (vals + 1).to(torch.int32)
    exact = torch.sum(vals, dim=-1)
    # the reference's approx_bsn_counts / spatial_temporal_counts, through
    # the kernels' front door
    out = approx_bsn(counts, spec, cycles=cycles)
    approx = spec.scale * (out - cycles * spec.out_bsl // 2)
    err = (approx - exact).to(torch.float32) / width
    return float(torch.mean(err * err))


def candidates(width: int) -> list:
    """(spec, fold, stride, clip sigmas) over clip windows, strides and
    temporal folds."""
    out = []
    for fold in (1, 4, 9):
        w = width // fold
        if w * fold != width or w % 64:
            continue
        m = w // 64
        sigma = (w * 0.32) ** 0.5
        for stride in (2, 4, 8):
            for nsig in (2.0, 3.0, 4.0):
                sorted2 = m * 32
                win = int(min(nsig * sigma, sorted2 // 2))
                win = max(stride, win // stride * stride)
                clip = (sorted2 - 2 * win) // 2
                if clip < 0:
                    continue
                try:
                    spec = ApproxBSNSpec(
                        width=w, in_bsl=IN_BSL,
                        stages=(StageSpec(64, SubSampleSpec(48, 1)),
                                StageSpec(m, SubSampleSpec(clip, stride))))
                except ValueError:
                    continue
                out.append((spec, fold, stride, nsig))
    return out


def run(width: int = 4608, n: int = 2048,
        device: str | torch.device | None = None) -> list:
    """Print the Pareto front; return every (adp, mse, fold, stride,
    sigmas, spec), sorted."""
    base = hwmodel.bsn_cost(width * IN_BSL)
    print(f"[dse] width {width}: baseline BSN adp={base.adp:.3e} "
          f"(area {base.area_um2:.3e} um2)")
    results = []
    for spec, fold, stride, nsig in candidates(width):
        if fold == 1:
            adp = hwmodel.approx_bsn_cost(spec).adp
        else:
            cost = hwmodel.spatial_temporal_cost(spec, fold)
            adp = cost.area_um2 * fold * cost.delay_ns
        mse = measure_mse(spec, fold, n, device=device)
        results.append((adp, mse, fold, stride, nsig, spec))
    results.sort(key=lambda r: r[:5])
    front, best = [], float("inf")
    for r in results:
        if r[1] < best:
            front.append(r)
            best = r[1]
    print(f"[dse] {len(results)} configs, Pareto front:")
    print("   adp_red   mse        fold stride clip_sigma  out_bsl")
    for adp, mse, fold, stride, nsig, spec in front:
        print(f"   {base.adp / adp:6.1f}x  {mse:.2e}  {fold:4d} {stride:5d} "
              f"{nsig:9.1f}  {spec.out_bsl:6d}")
    return results


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=4608)
    ap.add_argument("--rows", type=int, default=2048,
                    help="drawn rows a configuration")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(args.width, args.rows, args.device)


if __name__ == "__main__":
    main()
