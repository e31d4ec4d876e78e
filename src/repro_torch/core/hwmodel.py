"""Gate-level hardware cost model (paper Figs 2, 4, 9, 13; Tables IV, V).

Port of ``repro.core.hwmodel``: plain arithmetic over the port's
``ApproxBSNSpec`` and ``TERNARY_MUL_GATES``, no tensor op.  Area, delay
and energy are modelled from Batcher comparator counts, with two unit
constants calibrated so that the model gives the paper's Table V
baseline exactly:

    baseline BSN for a 3x3x512 conv (4608 products x 2-bit BSL = 9216
    bits, padded to 16384): area 2.95e5 um^2, delay 4.33 ns.

    comparators(16384) = 16384 * 14 * 15 / 4 = 860,160, 2 gates each
      -> GATE_AREA_UM2  = 2.95e5 / 1.72e6 = 0.1715 um^2 a gate
    depth(16384) = 14 * 15 / 2 = 105 comparator levels
      -> LEVEL_DELAY_NS = 4.33 / 105      = 0.04124 ns a level

Everything else (approximate BSNs, multipliers, SI) is predicted from
the same constants.
"""

from __future__ import annotations

from dataclasses import dataclass

from .bsn import ApproxBSNSpec
from .multiplier import TERNARY_MUL_GATES

__all__ = ["GATE_AREA_UM2", "LEVEL_DELAY_NS", "bitonic_comparators",
           "bitonic_depth", "BlockCost", "bsn_cost", "approx_bsn_cost",
           "spatial_temporal_cost", "multiplier_array_cost", "datapath_cost",
           "tops_per_watt", "describe_spec"]

GATE_AREA_UM2 = 2.95e5 / (2 * 860160)      # calibrated (module docstring)
LEVEL_DELAY_NS = 4.33 / 105                # calibrated
GATES_PER_COMPARATOR = 2                   # AND + OR on 1-bit wires
# energy: calibrated so that the §II silicon's peak (198.9 TOPS/W at
# 0.65 V, 200 MHz, 2-bit BSL MAC) is what tops_per_watt() gives
_EQUIV_GATES_PER_MAC_2BIT = TERNARY_MUL_GATES + 2 * 2 * 2.625
_PEAK_TOPS_PER_WATT = 198.9
_NOMINAL_V = 0.65
GATE_ENERGY_FJ = 1e3 / (_PEAK_TOPS_PER_WATT * _EQUIV_GATES_PER_MAC_2BIT * 0.5)


def _ceil_pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def bitonic_comparators(n_bits: int) -> int:
    """Comparators of a Batcher bitonic sorter over n wires (padded to a
    power of two)."""
    m = _ceil_pow2(n_bits)
    lg = m.bit_length() - 1
    return m * lg * (lg + 1) // 4


def bitonic_depth(n_bits: int) -> int:
    """Comparator levels on the critical path."""
    m = _ceil_pow2(n_bits)
    lg = m.bit_length() - 1
    return lg * (lg + 1) // 2


@dataclass(frozen=True)
class BlockCost:
    area_um2: float
    delay_ns: float
    cycles: int = 1

    @property
    def adp(self) -> float:
        """Area-delay product, um^2 ns (the paper's efficiency metric)."""
        return self.area_um2 * self.delay_ns * self.cycles

    def __add__(self, other: "BlockCost") -> "BlockCost":
        return BlockCost(self.area_um2 + other.area_um2,
                         self.delay_ns + other.delay_ns,
                         max(self.cycles, other.cycles))


def bsn_cost(n_bits: int) -> BlockCost:
    """The exact (baseline) BSN of an n-bit accumulation."""
    area = bitonic_comparators(n_bits) * GATES_PER_COMPARATOR * GATE_AREA_UM2
    return BlockCost(area, bitonic_depth(n_bits) * LEVEL_DELAY_NS)


def approx_bsn_cost(spec: ApproxBSNSpec) -> BlockCost:
    """The spatial approximate BSN (paper §IV-B): the sum of its stages'
    sub-BSNs.  Clipping and sub-sampling are wiring (free); stage i has
    ``width / prod(groups up to i)`` sub-BSNs, each sorting ``group_i *
    bsl_i`` wires."""
    area = delay = 0.0
    n_codes = spec.width
    for stage, bsl_in in zip(spec.stages, spec.layer_bsls()[:-1]):
        n_codes //= stage.group
        sub = bsn_cost(stage.group * bsl_in)
        area += n_codes * sub.area_um2
        delay += sub.delay_ns
    return BlockCost(area, delay)


def spatial_temporal_cost(spec: ApproxBSNSpec, cycles: int) -> BlockCost:
    """Temporal folding: one spatial pipeline reused over ``cycles``
    cycles, plus the small exact accumulator of the compressed partial
    sums (its delay pipelined over the cycles)."""
    spatial = approx_bsn_cost(spec)
    acc = bsn_cost(spec.out_bsl * cycles)
    return BlockCost(spatial.area_um2 + acc.area_um2,
                     spatial.delay_ns + acc.delay_ns / cycles,
                     cycles=cycles)


def multiplier_array_cost(width: int) -> BlockCost:
    """The bank of ternary multipliers feeding the BSN (5 gates each, one
    level)."""
    return BlockCost(width * TERNARY_MUL_GATES * GATE_AREA_UM2,
                     2 * LEVEL_DELAY_NS)


def datapath_cost(width: int, adder: BlockCost) -> BlockCost:
    """One output neuron's datapath: the multipliers and the adder."""
    return multiplier_array_cost(width) + adder


def tops_per_watt(act_bsl: int = 2, voltage: float = _NOMINAL_V) -> float:
    """Peak efficiency: 2 operations a MAC, energy ~ gates x E_gate x V^2,
    calibrated to the silicon's 198.9 TOPS/W at 0.65 V (Fig 4); the gates
    grow linearly with the BSL (Fig 2's trade-off)."""
    gates = _EQUIV_GATES_PER_MAC_2BIT * (act_bsl / 2)
    e_mac_fj = gates * GATE_ENERGY_FJ * (voltage / _NOMINAL_V) ** 2
    return 2.0 / e_mac_fj * 1e3


def describe_spec(spec: ApproxBSNSpec, cycles: int = 1) -> str:
    stages = ", ".join(f"g{si.group}/c{si.sub.clip}/s{si.sub.stride}"
                       for si in spec.stages)
    return (f"width={spec.width} bsl={spec.in_bsl} stages=[{stages}] "
            f"out_bsl={spec.out_bsl} scale={spec.scale} cycles={cycles}")
