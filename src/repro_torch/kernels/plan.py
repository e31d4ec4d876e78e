"""Launch plans of the port's CUDA kernels, for the kernel audit.

Port of ``repro.kernels.plan``.  There a Pallas kernel's launch geometry
(grid, BlockSpec index maps, scratch) is one Python object that both the
launch and the audit read.  Here the launches are C++ (``csrc/*.cu``):
each launcher computes its geometry in one C++ function that its launch
calls and that a ``*_geometry`` entry point reports
(``build.geometry``).  A :class:`LaunchPlan` is that geometry written
again in Python, plus what the C++ does not report: which element range
of each operand a program (block) reads or writes, as a function of its
block index and of the scalar operands (page tables, lengths), and the
split partials a program writes and its merge launch reads.
``chip_smoke.py`` holds every registered plan's geometry equal to the
entry point's on the card, so the audited geometry is the launched one.

A :class:`ScalarOperand` carries the value model the engine guarantees:
``max_value`` (the inclusive bound: page tables ``num_pages - 1``,
lengths ``maxp * page - 1``) and adversarial ``values`` (ragged lengths,
lengths that cross a split).  The bounds pass of
``repro_torch.analysis.kernel_audit`` fills each scalar array uniformly
with each of those values and evaluates every operand's range at each
grid dimension's extremes and at the plan's declared interior values
(``probe``): the ranges are monotone in the block index and in each
scalar entry within a component of the block index, so the extremes
bound every program (analysis/README.md, "The worst-case scalar model").

The plans mirror the C++ line by line where it decides a range; each
builder names the kernel it mirrors.  Constants are ``csrc``'s
``constexpr`` values (:data:`CSRC_CONSTANTS`; a test parses the sources
and holds them equal).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable

__all__ = ["CSRC_CONSTANTS", "SMEM_CAP", "ScalarOperand", "Operand",
           "Partials", "LaunchPlan", "paged_decode_plan",
           "paged_prefill_plan", "paged_prefill_kernel_code",
           "PAGED_PREFILL_KERNELS", "pw_layout", "pw_box_offsets",
           "ternary_matmul_plan", "approx_bsn_plan",
           "bsn_sort_plan", "flash_attention_plan", "flash_kernel_code",
           "flash_smem", "flash_stage_offsets", "kernel_instance"]

# csrc's constexpr values, by source file
CSRC_CONSTANTS = {
    "common.cuh": {"SMEM_CAP": 227 * 1024, "SC_SHIFT": 4,
                   "GEOMETRY_FIELDS": 11},
    "paged_attention.cu": {
        "THREADS": 128, "SPLIT_TOKENS": 512, "DEC_CT": 16, "DEC_WARPS": 4,
        "DEC_THREADS": 128, "DEC_STAGES": 3, "DEC_MAX_G": 16,
        "DEC_COMBINE_THREADS": 256, "PF_BK": 64, "PF_SPLIT_KEYS": 1024,
        "PF_STAGES": 3, "PF_MAX_ROWS": 128, "PW_PAGE": 16,
        "PW_CONSUMERS": 2, "PW_THREADS": 384, "PW_TAB": 64},
    "ternary_matmul.cu": {
        "THREADS": 256, "WARPS": 8, "TILE_N": 128, "UNROLL": 4,
        "MAX_OUT_BSL": 32, "DP4A_MAX_ROWS": 16, "TC_BM": 128, "TC_BN": 128,
        "TC_BK": 128, "TC_STAGES": 4, "TC_TILE": 128 * 128,
        "TC_FILL_BLOCKS": 132, "TC_MAX_SPLITS": 8},
    "approx_bsn.cu": {"MAX_STAGES": 8},
    "bsn_sort.cu": {"MIN_BLOCK_ELEMS": 8192, "MAX_THREADS": 1024},
    "flash_attention.cu": {
        "WG_CONSUMERS": 2, "WG_BQ": 128, "WG_BK": 128, "WG_STAGES": 3,
        "WG_THREADS": 384, "WG_PRODUCER_REGS": 24, "WG_CONSUMER_REGS": 240,
        "TC_WARPS": 8, "TC_BQ": 128, "TC_BK": 64, "TC_STAGES": 3,
        "TC_THREADS": 256, "BQ": 64, "BK": 64, "THREADS": 128},
}
_PA = CSRC_CONSTANTS["paged_attention.cu"]
_TM = CSRC_CONSTANTS["ternary_matmul.cu"]
_FL = CSRC_CONSTANTS["flash_attention.cu"]
SMEM_CAP = CSRC_CONSTANTS["common.cuh"]["SMEM_CAP"]

# KV kinds and q dtype codes (csrc/common.cuh)
KV_F32, KV_BF16, KV_INT8, KV_SC = 0, 1, 2, 3
Q_F32, Q_BF16 = 0, 1
_CSRC = "src/repro_torch/kernels/csrc/"

Range = tuple[int, int]                 # elements [lo, hi) of an operand


@dataclass(frozen=True)
class ScalarOperand:
    """A scalar array the kernel reads to pick addresses, and the values
    the engine guarantees it holds: ``0 .. max_value``, plus ``values``
    that are extreme for some range (a length one past a page, or that
    crosses a split)."""
    name: str
    shape: tuple[int, ...]
    max_value: int
    values: tuple[int, ...] = ()

    def fills(self) -> tuple[int, ...]:
        vals = {0, self.max_value}
        vals.update(v for v in self.values if 0 <= v <= self.max_value)
        return tuple(sorted(vals))


@dataclass(frozen=True)
class Operand:
    """One buffer a launch reads or writes: its element count (0 for a
    null pointer) and ``access(program, scalars)``, the element ranges
    ``[lo, hi)`` that block ``program = (x, y, z)`` touches."""
    name: str
    numel: int
    itemsize: int
    access: Callable[[tuple[int, int, int], dict], list[Range]]
    write: bool = False


@dataclass(frozen=True)
class Partials:
    """Split partials: ``slots(program, scalars)`` lists the partial slots
    a block writes, ``reads(scalars)`` every slot the merge launch reads
    (one entry a read)."""
    operand: str
    n_slots: int
    slots: Callable[[tuple[int, int, int], dict], list[int]]
    reads: Callable[[dict], list[int]]


@dataclass(frozen=True)
class LaunchPlan:
    """One launch: the geometry ``*_geometry`` reports, and what each of
    its blocks touches.  ``kernel`` is the instance the ptxas log names
    (:func:`kernel_instance`); ``code`` Geometry::kernel; ``accumulate``
    declares the operands that more than one block writes and how
    (``"split-combine"``: split partials merged by ``combine``;
    ``"atomic-add"``: K splits summed with atomics into a zeroed
    output); ``int_offsets`` the largest values the kernel computes in
    32-bit ``int`` (offsets, positions, loop bounds); ``no_spills`` that
    its machine code must not use local memory."""
    name: str
    kernel: str
    source: str
    code: int
    grid: tuple[int, int, int]
    threads: int
    smem: int
    static_smem: int = 0
    splits: int = 1
    per_split: int = 0
    block: int = 0
    scalars: tuple[ScalarOperand, ...] = ()
    operands: tuple[Operand, ...] = ()
    probe: tuple[tuple[int, ...], ...] | None = None
    partials: Partials | None = None
    accumulate: dict[str, str] = field(default_factory=dict)
    int_offsets: dict[str, int] = field(default_factory=dict)
    combine: "LaunchPlan | None" = None
    no_spills: bool = False

    def geometry(self) -> dict[str, int]:
        """The plan in ``build.GEOMETRY_FIELDS`` form."""
        c = self.combine
        return {"kernel": self.code, "grid_x": self.grid[0],
                "grid_y": self.grid[1], "grid_z": self.grid[2],
                "threads": self.threads, "smem": self.smem,
                "splits": self.splits, "per_split": self.per_split,
                "block": self.block,
                "combine_grid": c.grid[0] if c else 0,
                "combine_threads": c.threads if c else 0}

    def probe_points(self) -> list[tuple[int, int, int]]:
        """The blocks the bounds pass evaluates: each grid dimension at
        its extremes and at its declared interior values."""
        dims = self.probe or tuple((0, g - 1) for g in self.grid)
        dims = tuple(sorted({v for v in d if 0 <= v < g}) or [0]
                     for d, g in zip(dims, self.grid))
        return list(itertools.product(*dims))

    def programs(self):
        return itertools.product(*(range(g) for g in self.grid))


def kernel_instance(name: str, *targs: str) -> str:
    """A kernel instance as its mangled name holds it: the length-prefixed
    name and the template arguments (``Li64E`` for 64, ``Lb0E`` for
    false, ``f`` for float, ``a`` for int8_t)."""
    frag = f"{len(name)}{name}"
    return frag + (f"I{''.join(targs)}EE" if targs else "E")


def _li(v: int) -> str:
    return f"Li{v}E"


def _lb(v: bool) -> str:
    return f"Lb{int(v)}E"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_probe(outer: int, inner: int) -> tuple[int, ...]:
    """Block indices ``x = a * inner + b`` at every pair of extremes of
    ``a`` and ``b``: a range that depends on ``b`` alone is not monotone
    in ``x``."""
    return tuple(sorted({a * inner + b for a in (0, outer - 1)
                         for b in (0, inner - 1)}))


def _page_shift(page: int) -> int:
    s = (page - 1).bit_length()
    return s if 1 << s == page else -1


def _rows_range(phys: int, page: int, o_lo: int, o_hi: int, Hkv: int,
                h: int, D: int) -> Range:
    """Elements of a (N, page, Hkv, D) pool that rows ``o_lo..o_hi`` of
    page ``phys``, KV head ``h``, occupy ([lo, hi), monotone in all)."""
    return (((phys * page + o_lo) * Hkv + h) * D,
            ((phys * page + o_hi) * Hkv + h) * D + D)


def _offsets(p_lo: int, p_hi: int, page: int) -> tuple[int, int]:
    """Least and greatest in-page offset of positions ``p_lo..p_hi``."""
    if p_hi - p_lo + 1 >= page or p_lo // page != p_hi // page:
        return 0, page - 1
    return p_lo % page, p_hi % page


# ---------------------------------------------------------------------------
# paged attention (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------

def _raw(D: int, kind: int) -> tuple[int, int, bool]:
    """Raw<D, KIND>: bytes a row, arrays staged, scaled."""
    return (2 * D if kind == KV_BF16 else D, 4 if kind == KV_SC else 2,
            kind != KV_BF16)


def paged_f32_smem(rows: int, page: int, D: int) -> int:
    """smem_bytes(rows, page, D) of the CUDA-core kernels."""
    return 4 * (2 * rows * D + page * (2 * D + 1) + rows * page + 3 * rows)


def dec_layout_bytes(D: int, kind: int, G: int) -> int:
    """DecLayout<D, KIND>::bytes(G) of the split decode kernel."""
    row, narr, scaled = _raw(D, kind)
    st = D + 8
    tile = _PA["DEC_CT"] * st * 2
    raw_row = st * 2 if kind == KV_BF16 else row
    slot = narr * _PA["DEC_CT"] * raw_row + (2 * _PA["DEC_CT"] * 4
                                             if scaled else 0)
    nct = 0 if kind == KV_BF16 else narr
    warp = _PA["DEC_STAGES"] * slot + nct * tile
    return _PA["DEC_WARPS"] * warp + 4 * _PA["DEC_WARPS"] * G * (D + 2)


def pf_layout_bytes(D: int, kind: int, rows: int) -> int:
    """PfLayout<D, KIND>::bytes(rows) of the tensor-core prefill kernel."""
    _, narr, _ = _raw(D, kind)
    st = D + 8
    tile = _PA["PF_BK"] * st * 2
    slot = 2 * tile if kind == KV_BF16 \
        else narr * _PA["PF_BK"] * D + 2 * _PA["PF_BK"] * 4
    nct = 0 if kind == KV_BF16 else narr
    return _PA["PF_STAGES"] * slot + nct * tile + rows * st * 2


# Geometry::kernel of paged_attn_prefill_launch, by name
PAGED_PREFILL_KERNELS = {0: "prefill_kernel", 1: "paged_prefill_mma_kernel",
                         2: "paged_prefill_wgmma_kernel"}


def paged_prefill_kernel_code(D: int, page: int, kv_kind: int,
                              q_dtype: int = Q_BF16) -> int:
    """The kernel prefill_geometry picks, by dtype, head dim and page size
    alone (never by block_q, C or start): the CUDA-core ``prefill_kernel``
    for float32 q or pools, ``paged_prefill_wgmma_kernel`` for bf16 q at
    D 64 / 128 on 16-position pages (wgmma_route), else
    ``paged_prefill_mma_kernel``."""
    if _f32_route(q_dtype, kv_kind):
        return 0
    return 2 if D in (64, 128) and page == _PA["PW_PAGE"] else 1


def pw_layout(D: int, kind: int) -> dict[str, int]:
    """PwLayout<D, KIND> of the wgmma prefill: byte offsets from the
    1024-aligned base, and ``bytes`` (BYTES, the launch's shared memory)."""
    _, narr, scaled = _raw(D, kind)
    bf = kind == KV_BF16
    bk = _PA["PF_BK"]
    tile = bk * D * 2
    stages, raw_stages = (4, 0) if bf else (3, 3)
    raw = narr * bk * D
    raw_off = stages * 2 * tile
    q_wg = 64 * D * 2
    q_off = raw_off + raw_stages * raw
    scale_off = q_off + _PA["PW_CONSUMERS"] * q_wg
    tab_off = scale_off + (stages * 2 * bk * 4 if scaled else 0)
    bar_off = tab_off + _PA["PW_TAB"] * 4
    return dict(tile=tile, stages=stages, raw_stages=raw_stages, raw=raw,
                raw_off=raw_off, q_wg=q_wg, q_off=q_off,
                scale_off=scale_off, tab_off=tab_off, bar_off=bar_off,
                bytes=1024 + bar_off + 8 * (3 * stages + raw_stages))


def pw_box_offsets(D: int, kind: int) -> list[int]:
    """The byte offsets (from the 1024-aligned base) of every 128B-
    swizzled box the wgmma prefill's descriptors read: each stage's K and
    V page boxes (TMA's, or the rows the producer widens into) and each
    consumer's q boxes."""
    lay = pw_layout(D, kind)
    bk, page = _PA["PF_BK"], _PA["PW_PAGE"]
    offs = [st * 2 * lay["tile"] + kv * lay["tile"] + c * bk * 128
            + p * page * 128
            for st in range(lay["stages"]) for kv in (0, 1)
            for c in range(D // 64) for p in range(bk // page)]
    offs += [lay["q_off"] + wg * lay["q_wg"] + c * 64 * 128
             for wg in range(_PA["PW_CONSUMERS"]) for c in range(D // 64)]
    return offs


def _pool_operands(N: int, page: int, Hkv: int, D: int, kind: int,
                   rows_of: Callable) -> list[Operand]:
    """The K / V pools (and scales and residuals) of a paged launch;
    ``rows_of(program, scalars)`` gives (phys, o_lo, o_hi, h) per page a
    block reads, or []."""
    def pool(name, itemsize, width):
        def access(p, sc):
            return [_rows_range(ph, page, lo, hi, Hkv, h, width)
                    for ph, lo, hi, h in rows_of(p, sc)]
        return Operand(name, N * page * Hkv * width, itemsize, access)
    isz = 4 if kind == KV_F32 else 2 if kind == KV_BF16 else 1
    ops = [pool("k_pages", isz, D), pool("v_pages", isz, D)]
    if kind in (KV_INT8, KV_SC):
        ops += [pool("k_scale", 4, 1), pool("v_scale", 4, 1)]
    if kind == KV_SC:
        ops += [pool("k_resid", 1, D), pool("v_resid", 1, D)]
    return ops


def _f32_route(q_dtype: int, kind: int) -> bool:
    return q_dtype == Q_F32 or kind == KV_F32


def _length_values(page: int, maxp: int) -> tuple[int, ...]:
    """Lengths a page or a split boundary makes extreme: ``len % page`` in
    {0, 1, page - 1} around each of the first pages, and each side of
    every split the table reaches."""
    split = _PA["SPLIT_TOKENS"]
    vals = {k * page + d for k in (1, 2) for d in (-1, 0, 1)}
    vals |= {k * split + d for k in range(1, maxp * page // split + 1)
             for d in (-1, 0, 1)}
    return tuple(sorted(v for v in vals if 0 < v < maxp * page))


def paged_decode_plan(*, S: int, Hkv: int, G: int, D: int, page: int,
                      maxp: int, num_pages: int, kv_kind: int,
                      q_dtype: int = Q_BF16) -> LaunchPlan:
    """paged_attn_decode_launch: ``decode_kernel`` (float32 q or pools,
    grid (S, Hkv)) or ``paged_decode_split_kernel`` (grid (S Hkv, NS))
    and, when NS > 1, ``paged_decode_combine_kernel``."""
    N = num_pages
    qsz = 4 if q_dtype == Q_F32 else 2
    tables = ScalarOperand("tables", (S, maxp), N - 1)
    lengths = ScalarOperand("lengths", (S,), maxp * page - 1,
                            _length_values(page, maxp))
    scalars = (tables, lengths)
    tab_op = lambda acc: Operand("tables", S * maxp, 4, acc)  # noqa: E731
    len_op = Operand("lengths", S, 4,
                     lambda p, sc: [(p[0] // Hkv, p[0] // Hkv + 1)])
    if _f32_route(q_dtype, kv_kind):
        # decode_kernel: block (s, h) walks pages p <= length / page
        def pages(p, sc):
            s = p[0]
            return min(maxp - 1, int(sc["lengths"][s]) // page)

        def rows(p, sc):
            s, h = p[0], p[1]
            return [(int(sc["tables"][s, 0]), 0, page - 1, h)]

        def head(p, sc):
            hd = (p[0] * Hkv + p[1]) * G
            return [(hd * D, (hd + G) * D)]
        ops = [Operand("q", S * Hkv * G * D, qsz, head),
               tab_op(lambda p, sc: [(p[0] * maxp,
                                      p[0] * maxp + pages(p, sc) + 1)]),
               Operand("lengths", S, 4, lambda p, sc: [(p[0], p[0] + 1)]),
               *_pool_operands(N, page, Hkv, D, kv_kind, rows),
               Operand("out", S * Hkv * G * D, qsz, head, write=True)]
        qt = "f" if q_dtype == Q_F32 else "13__nv_bfloat16"
        return LaunchPlan(
            "paged_attn_decode",
            kernel_instance("decode_kernel", qt, _li(kv_kind)),
            _CSRC + "paged_attention.cu:213", 0, (S, Hkv, 1),
            _PA["THREADS"], paged_f32_smem(G, page, D), scalars=scalars,
            operands=tuple(ops),
            int_offsets={"maxp * page": maxp * page, "G * D": G * D,
                         "page * D": page * D, "G * page": G * page})
    ps = _page_shift(page)
    if ps < 0 or G > _PA["DEC_MAX_G"]:
        raise ValueError(f"the split decode kernel refuses page={page}, "
                         f"G={G}")
    split, ct = _PA["SPLIT_TOKENS"], _PA["DEC_CT"]
    NS = _cdiv(maxp << ps, split)
    n_rows = S * Hkv * NS * G

    def n_split(sc, s):
        return int(sc["lengths"][s]) // split + 1

    def window(p, sc):
        """Positions [lo, hi] block (s, h, j) reads, or None."""
        s, j = p[0] // Hkv, p[1]
        length = int(sc["lengths"][s])
        if j >= n_split(sc, s):
            return None
        c0 = j * (split // ct)
        c_end = min(c0 + split // ct, length // ct + 1)
        lo = c0 * ct
        hi = min(c_end * ct - 1, ((length >> ps) << ps) + page - 1)
        return (lo, hi) if hi >= lo else None

    def rows(p, sc):
        w = window(p, sc)
        if w is None:
            return []
        o_lo, o_hi = _offsets(*w, page)
        return [(int(sc["tables"][p[0] // Hkv, 0]), o_lo, o_hi,
                 p[0] % Hkv)]

    def table(p, sc):
        w = window(p, sc)
        s = p[0] // Hkv
        return [] if w is None else [(s * maxp + (w[0] >> ps),
                                      s * maxp + (w[1] >> ps) + 1)]

    def head(p, sc):
        if window(p, sc) is None:
            return []
        hd = p[0] * G
        return [(hd * D, (hd + G) * D)]

    def out(p, sc):
        s = p[0] // Hkv
        return head(p, sc) if n_split(sc, s) == 1 else []

    def part(p, sc):
        s = p[0] // Hkv
        if window(p, sc) is None or n_split(sc, s) == 1:
            return []
        pr = (p[0] * NS + p[1]) * G
        return [(pr * D, (pr + G) * D),
                (n_rows * D + pr, n_rows * D + pr + G),
                (n_rows * (D + 1) + pr, n_rows * (D + 1) + pr + G)]

    def slots(p, sc):
        s = p[0] // Hkv
        ok = window(p, sc) is not None and n_split(sc, s) > 1
        return [p[0] * NS + p[1]] if ok else []

    def reads(sc):
        return [x * NS + j for x in range(S * Hkv)
                for j in range(n_split(sc, x // Hkv))
                if n_split(sc, x // Hkv) > 1]

    scratch = S * Hkv * NS * G * (D + 2) if NS > 1 else 0
    ops = (Operand("q", S * Hkv * G * D, 2, head), tab_op(table), len_op,
           *_pool_operands(N, page, Hkv, D, kv_kind, rows),
           Operand("out", S * Hkv * G * D, 2, out, write=True),
           Operand("part", scratch, 4, part, write=True))
    combine = None
    if NS > 1:
        def c_part(p, sc):
            if n_split(sc, p[0] // Hkv) == 1:
                return []
            r0 = p[0] * NS * G
            hi = r0 + NS * G
            return [(r0 * D, hi * D), (n_rows * D + r0, n_rows * D + hi),
                    (n_rows * (D + 1) + r0, n_rows * (D + 1) + hi)]

        def c_out(p, sc):
            if n_split(sc, p[0] // Hkv) == 1:
                return []
            return [(p[0] * G * D, (p[0] + 1) * G * D)]
        combine = LaunchPlan(
            "paged_attn_decode",
            kernel_instance("paged_decode_combine_kernel"),
            _CSRC + "paged_attention.cu:750", 1, (S * Hkv, 1, 1),
            _PA["DEC_COMBINE_THREADS"], 0, scalars=scalars,
            operands=(Operand("part", scratch, 4, c_part), len_op,
                      Operand("out", S * Hkv * G * D, 2, c_out,
                              write=True)),
            probe=(_split_probe(S, Hkv), (0,), (0,)),
            int_offsets={"G * D": G * D})
    return LaunchPlan(
        "paged_attn_decode",
        kernel_instance("paged_decode_split_kernel", _li(D), _li(kv_kind)),
        _CSRC + "paged_attention.cu:581", 1, (S * Hkv, NS, 1),
        _PA["DEC_THREADS"], dec_layout_bytes(D, kv_kind, G), splits=NS,
        scalars=scalars, operands=ops,
        probe=(_split_probe(S, Hkv), (0, NS - 1)),
        partials=Partials("part", S * Hkv * NS, slots, reads)
        if NS > 1 else None,
        accumulate={"part": "split-combine"} if NS > 1 else {},
        int_offsets={"maxp * page": maxp * page, "S * Hkv": S * Hkv,
                     "G * D": G * D},
        combine=combine, no_spills=D == 64)


def paged_prefill_plan(*, G: int, C: int, Hkv: int, Gq: int, D: int,
                       page: int, width: int, start: int, num_pages: int,
                       kv_kind: int, block_q: int = 32,
                       q_dtype: int = Q_BF16) -> LaunchPlan:
    """paged_attn_prefill_launch: ``prefill_kernel`` (float32, grid
    (G Hq, ceil(C / bq))), or ``paged_prefill_wgmma_kernel`` (bf16 q at
    D 64 / 128 on 16-position pages) or ``paged_prefill_mma_kernel``
    (grid (G Hkv, ceil(C / bq), NS)) and, when NS > 1,
    ``paged_prefill_combine_kernel``.  ``block_q`` is the wrapper's ``bq``
    (``min(block_q, C)``).  Both tensor-core kernels read the same table
    lanes and page rows (whole pages: C and start are page multiples; the
    wgmma kernel's TMA boxes of pages past the chunk's last lie past the
    pool and read nothing)."""
    N, Hq = num_pages, Hkv * Gq
    qsz = 4 if q_dtype == Q_F32 else 2
    tables = ScalarOperand("tables", (G, width), N - 1)
    scalars = (tables,)
    q_numel = G * C * Hq * D
    if _f32_route(q_dtype, kv_kind):
        bq = block_q
        n_pg = (start + C) // page

        def span(p):
            g, hq = p[0] // Hq, p[0] % Hq
            row0 = p[1] * bq
            rows = min(bq, C - row0)
            return g, hq, row0, rows

        def qrange(p, sc):
            g, hq, row0, rows = span(p)
            return [(((g * C + row0) * Hq + hq) * D,
                     ((g * C + row0 + rows - 1) * Hq + hq) * D + D)]

        def last_page(p):
            _, _, row0, rows = span(p)
            return min(n_pg - 1, (start + row0 + rows - 1) // page)

        def rows_of(p, sc):
            g, hq, _, _ = span(p)
            return [(int(sc["tables"][g, 0]), 0, page - 1, hq // Gq)]
        ops = (Operand("q", q_numel, qsz, qrange),
               Operand("tables", G * width, 4,
                       lambda p, sc: [(span(p)[0] * width,
                                       span(p)[0] * width + last_page(p)
                                       + 1)]),
               *_pool_operands(N, page, Hkv, D, kv_kind, rows_of),
               Operand("out", q_numel, qsz, qrange, write=True))
        qt = "f" if q_dtype == Q_F32 else "13__nv_bfloat16"
        return LaunchPlan(
            "paged_attn_prefill",
            kernel_instance("prefill_kernel", qt, _li(kv_kind)),
            _CSRC + "paged_attention.cu:265", 0, (G * Hq, _cdiv(C, bq), 1),
            _PA["THREADS"], paged_f32_smem(bq, page, D), block=bq,
            scalars=scalars, operands=ops,
            probe=(_split_probe(G, Hq), (0, _cdiv(C, bq) - 1)),
            int_offsets={"start + C": start + C, "bq * D": bq * D,
                         "page * D": page * D, "bq * page": bq * page})
    ps = _page_shift(page)
    if ps < 0 or Gq > _PA["PF_MAX_ROWS"]:
        raise ValueError(f"the tensor-core prefill kernel refuses "
                         f"page={page}, Gq={Gq}")
    bq = min(block_q, C, _PA["PF_MAX_ROWS"] // Gq)
    code = paged_prefill_kernel_code(D, page, kv_kind, q_dtype)
    if code == 2:
        threads = 128 * (_cdiv(bq * Gq, 64) + 1)
        smem = pw_layout(D, kv_kind)["bytes"]
        instance = kernel_instance("paged_prefill_wgmma_kernel", _li(D),
                                   _li(kv_kind))
        source = _CSRC + "paged_attention.cu:1187"
    else:
        warps = _cdiv(bq * Gq, 16)
        threads = 32 * warps
        smem = pf_layout_bytes(D, kv_kind, 16 * warps)
        instance = kernel_instance("paged_prefill_mma_kernel", _li(D),
                                   _li(kv_kind))
        source = _CSRC + "paged_attention.cu:815"
    bk, skeys = _PA["PF_BK"], _PA["PF_SPLIT_KEYS"]
    tps = skeys // bk
    NS = _cdiv(start + C, skeys)
    kv_end = start + C
    n_part = G * Hkv * C * Gq * NS
    rows_total = G * C * Hkv * Gq

    def block(p):
        g, h = p[0] // Hkv, p[0] % Hkv
        row0 = p[1] * bq
        n_rows = min(bq, C - row0) * Gq
        hi_pos = start + row0 + (n_rows - 1) // Gq
        return g, h, row0, n_rows, hi_pos

    def keys(p):
        """Keys [lo, hi] block p reads, or None (wholly in the future)."""
        _, _, _, _, hi_pos = block(p)
        t0 = p[2] * tps
        if t0 * bk > hi_pos:
            return None
        n_tiles = min(hi_pos // bk + 1, t0 + tps) - t0
        hi = min((t0 + n_tiles) * bk, kv_end) - 1
        return (t0 * bk, hi) if hi >= t0 * bk else None

    def rid(g, h, row0, i):
        return ((g * C + row0 + i // Gq) * Hkv + h) * Gq + i % Gq

    def qrange(p, sc):
        if keys(p) is None:
            return []
        g, h, row0, n_rows, _ = block(p)
        return [(rid(g, h, row0, 0) * D, (rid(g, h, row0, n_rows - 1) + 1)
                 * D)]

    def rows_of(p, sc):
        k = keys(p)
        if k is None:
            return []
        o_lo, o_hi = _offsets(*k, page)
        return [(int(sc["tables"][p[0] // Hkv, 0]), o_lo, o_hi,
                 p[0] % Hkv)]

    def table(p, sc):
        k = keys(p)
        g = p[0] // Hkv
        return [] if k is None else [(g * width + (k[0] >> ps),
                                      g * width + (k[1] >> ps) + 1)]

    def written(p, partial: bool):
        """Rows i (an ascending range) block p writes to out or part."""
        if keys(p) is None:
            return None
        g, h, row0, n_rows, _ = block(p)
        j = p[2]
        live = [i for i in range(n_rows)
                if j <= (start + row0 + i // Gq) // skeys
                and ((start + row0 + i // Gq) >= skeys) == partial]
        return (g, h, row0, live) if live else None

    def out(p, sc):
        w = written(p, False)
        if w is None:
            return []
        g, h, row0, live = w
        return [(rid(g, h, row0, live[0]) * D,
                 (rid(g, h, row0, live[-1]) + 1) * D)]

    def part(p, sc):
        w = written(p, True)
        if w is None:
            return []
        g, h, row0, live = w
        lo = rid(g, h, row0, live[0]) * NS + p[2]
        hi = rid(g, h, row0, live[-1]) * NS + p[2]
        return [(lo * D, (hi + 1) * D), (n_part * D + lo, n_part * D + hi
                                         + 1),
                (n_part * (D + 1) + lo, n_part * (D + 1) + hi + 1)]

    def slots(p, sc):
        w = written(p, True)
        if w is None:
            return []
        g, h, row0, live = w
        return [rid(g, h, row0, i) * NS + p[2] for i in live]

    def combine_splits(r):
        pos = start + (r // Hq) % C
        return pos // skeys + 1

    def reads(sc):
        return [r * NS + j for r in range(rows_total)
                for j in range(combine_splits(r)) if combine_splits(r) > 1]

    scratch = rows_total * NS * (D + 2) if NS > 1 else 0
    ops = (Operand("q", q_numel, 2, qrange),
           Operand("tables", G * width, 4, table),
           *_pool_operands(N, page, Hkv, D, kv_kind, rows_of),
           Operand("out", q_numel, 2, out, write=True),
           Operand("part", scratch, 4, part, write=True))
    combine = None
    if NS > 1:
        n_el = rows_total * D

        def c_span(p):
            lo = p[0] * 256
            hi = min(lo + 256, n_el)
            return (lo, hi) if hi > lo else None

        def c_part(p, sc):
            sp = c_span(p)
            if sp is None:
                return []
            r_lo, r_hi = sp[0] // D, (sp[1] - 1) // D
            return [(r_lo * NS * D, (r_hi * NS + NS) * D),
                    (n_part * D + r_lo * NS, n_part * D + r_hi * NS + NS),
                    (n_part * (D + 1) + r_lo * NS,
                     n_part * (D + 1) + r_hi * NS + NS)]

        def c_out(p, sc):
            sp = c_span(p)
            return [] if sp is None else [sp]
        cgrid = _cdiv(n_el, 256)
        combine = LaunchPlan(
            "paged_attn_prefill",
            kernel_instance("paged_prefill_combine_kernel", _li(D),
                            _lb(code == 2)),
            _CSRC + "paged_attention.cu:1550", code, (cgrid, 1, 1), 256, 0,
            scalars=scalars,
            operands=(Operand("part", scratch, 4, c_part),
                      Operand("out", q_numel, 2, c_out, write=True)),
            int_offsets={"G * C * Hkv * Gq * D + 255": n_el + 255,
                         "start + C": start + C})
    return LaunchPlan(
        "paged_attn_prefill", instance, source, code,
        (G * Hkv, _cdiv(C, bq), NS), threads, smem, splits=NS,
        block=bq, scalars=scalars, operands=ops,
        probe=(_split_probe(G, Hkv), (0, _cdiv(C, bq) - 1), (0, NS - 1)),
        partials=Partials("part", rows_total * NS, slots, reads)
        if NS > 1 else None,
        accumulate={"part": "split-combine"} if NS > 1 else {},
        int_offsets={"start + C + PF_BK": start + C + bk,
                     "G * Hkv": G * Hkv,
                     "G * C * Hkv * Gq * D + 255": rows_total * D + 255},
        combine=combine, no_spills=D == 64)


# ---------------------------------------------------------------------------
# ternary matmul (csrc/ternary_matmul.cu)
# ---------------------------------------------------------------------------

def ternary_matmul_plan(*, batch: int, M: int, N: int, K: int,
                        out_bsl: int = 0, sms: int = 132) -> LaunchPlan:
    """ternary_matmul_launch at these (padded) sizes: the dp4a kernel at
    4 or 16 rows a block for M <= DP4A_MAX_ROWS (grid (N / 128, M / MT,
    batch x K splits)), else the wgmma kernel (grid (M / 128, N / 128,
    batch x K splits)); ``out_bsl > 0`` is the SI epilogue.  ``sms``:
    the card's SM count, which the dp4a kernel's K split reads."""
    si = out_bsl > 0
    name = "ternary_matmul_batched" if batch > 1 else "ternary_matmul"
    thr_numel = N * out_bsl if si else 0
    if M > _TM["DP4A_MAX_ROWS"]:
        bm, bn, bk = _TM["TC_BM"], _TM["TC_BN"], _TM["TC_BK"]
        row_tiles, col_tiles, kt = _cdiv(M, bm), _cdiv(N, bn), _cdiv(K, bk)
        kps = kt
        if not si and kt > 0:
            tiles = row_tiles * col_tiles * batch
            splits = _TM["TC_FILL_BLOCKS"] // tiles \
                if tiles < _TM["TC_FILL_BLOCKS"] else 1
            splits = min(splits, _TM["TC_MAX_SPLITS"])
            kps = _cdiv(kt, splits)
        splits = _cdiv(kt, kps) if kt > 0 else 1

        def tile(p):
            m0, n0 = p[0] * bm, p[1] * bn
            b, kt0 = p[2] // splits, (p[2] % splits) * kps
            k_end = min(K, min(kt, kt0 + kps) * bk)
            return b, m0, n0, kt0 * bk, k_end, min(m0 + bm, M), \
                min(n0 + bn, N)
        code, grid = 2, (row_tiles, col_tiles, batch * splits)
        smem = 1024 + (_TM["TC_STAGES"] + 1) * 2 * _TM["TC_TILE"] \
            + (bn * out_bsl * 4 if si else 0)
        block, per_split = bm, kps
        kernel = kernel_instance("ternary_matmul_mma_kernel", _lb(si))
        source = _CSRC + "ternary_matmul.cu:345"
        offsets = {"m0 + TC_BM": row_tiles * bm, "n0 + TC_BN": col_tiles * bn,
                   "k0 + TC_BK": kt * bk, "batch * splits": batch * splits}
    else:
        mt = 4 if M <= 4 else 16
        tn, gk = _TM["TILE_N"], K // 4
        col_tiles, row_tiles = _cdiv(N, tn), _cdiv(M, mt)
        fixed = (mt * tn + (tn * out_bsl if si else 0)) * 4
        gps = gk
        if not si and gk > 0:
            tiles = col_tiles * row_tiles * batch
            want = _cdiv(2 * sms, tiles)
            gps = _cdiv(gk, min(want, gk))
            gps = min(gps, (SMEM_CAP - fixed) // (mt * 4))
        splits = _cdiv(gk, gps) if gk > 0 else 1

        def tile(p):
            n0, m0 = p[0] * tn, p[1] * mt
            b, g0 = p[2] // splits, (p[2] % splits) * gps
            g1 = min(gk, g0 + gps)
            return b, m0, n0, 4 * g0, 4 * g1, min(m0 + mt, M), \
                min(n0 + tn, N)
        code, grid = (0 if mt == 4 else 1), (col_tiles, row_tiles,
                                             batch * splits)
        smem = fixed + mt * gps * 4
        block, per_split = mt, gps
        kernel = kernel_instance("ternary_matmul_kernel", _li(mt), _lb(si))
        source = _CSRC + "ternary_matmul.cu:99"
        offsets = {"n0 + TILE_N": col_tiles * tn, "4 * g1": K,
                   "MT * gps": mt * gps, "M": M,
                   "batch * splits": batch * splits}
    if batch * splits > 65535:
        raise ValueError(f"ternary_matmul refuses {batch} products x "
                         f"{splits} K splits")

    def x_rng(p, sc):
        b, m0, n0, k0, k1, m1, n1 = tile(p)
        if m0 >= M or k1 <= k0:
            return []
        base = b * M * K
        return [(base + m0 * K + k0, base + (m1 - 1) * K + k1)]

    def w_rng(p, sc):
        b, m0, n0, k0, k1, m1, n1 = tile(p)
        if n0 >= N or k1 <= k0:
            return []
        base = b * K * N
        return [(base + k0 * N + n0, base + (k1 - 1) * N + n1)]

    def t_rng(p, sc):
        b, m0, n0, k0, k1, m1, n1 = tile(p)
        return [(n0 * out_bsl, n1 * out_bsl)] if si and n0 < N else []

    def o_rng(p, sc):
        b, m0, n0, k0, k1, m1, n1 = tile(p)
        if m0 >= M or n0 >= N:
            return []
        base = b * M * N
        return [(base + m0 * N + n0, base + (m1 - 1) * N + n1)]
    probe_z = _split_probe(batch, splits)
    return LaunchPlan(
        name, kernel, source, code, grid, _TM["THREADS"], smem,
        splits=splits, per_split=per_split, block=block,
        operands=(Operand("x", batch * M * K, 1, x_rng),
                  Operand("w", batch * K * N, 1, w_rng),
                  Operand("thresholds", thr_numel, 4, t_rng),
                  Operand("out", batch * M * N, 4, o_rng, write=True)),
        probe=((0, grid[0] - 1), (0, grid[1] - 1), probe_z),
        accumulate={"out": "atomic-add"} if splits > 1 else {},
        int_offsets=offsets, no_spills=code == 2)


# ---------------------------------------------------------------------------
# approximate BSN, bitonic sort, flash attention
# ---------------------------------------------------------------------------

def approx_bsn_plan(*, rows: int, width: int, cycles: int,
                    stages: tuple[tuple[int, int, int], ...],
                    temporal: bool = False) -> LaunchPlan:
    """approx_bsn_launch: ``approx_bsn_kernel<T>``, grid (rows), T =
    width / 8 threads (one warp to 256); shared memory the two stage
    buffers, and the kernel's static reduction array."""
    sizes, n = [], width
    for group, _, _ in stages:
        n //= group
        sizes.append(n)
    buf0, buf1 = sizes[0], sizes[1] if len(sizes) > 1 else 0
    t = 32 if width <= 256 else 64 if width <= 512 else \
        128 if width <= 1024 else 256
    total = cycles * width
    return LaunchPlan(
        "approx_bsn_temporal" if temporal else "approx_bsn",
        kernel_instance("approx_bsn_kernel", _li(t)),
        _CSRC + "approx_bsn.cu:64", t, (rows, 1, 1), t, (buf0 + buf1) * 4,
        static_smem=t // 32 * 4,
        operands=(Operand("counts", rows * total, 4,
                          lambda p, sc: [(p[0] * total,
                                          (p[0] + 1) * total)]),
                  Operand("out", rows, 4, lambda p, sc: [(p[0], p[0] + 1)],
                          write=True)),
        int_offsets={"width": width, "rows": rows})


_SORT_TYPES = {0: ("a", 1), 1: ("i", 4), 2: ("f", 4)}


def bsn_sort_plan(*, rows: int, L: int, dtype: int) -> LaunchPlan:
    """bsn_sort_launch: ``bsn_sort_reg_kernel<T, RUN>`` over blocks of
    max(L, MIN_BLOCK_ELEMS) elements, one thread a run of RUN."""
    code, size = _SORT_TYPES[dtype]
    log_len = L.bit_length() - 1
    run = 64 if size == 1 and log_len == 16 else \
        128 if size == 1 and log_len >= 17 else 32
    elems = max(L, CSRC_CONSTANTS["bsn_sort.cu"]["MIN_BLOCK_ELEMS"])
    total = rows * L
    blocks = _cdiv(total, elems)

    def span(p, sc):
        return [(p[0] * elems, min((p[0] + 1) * elems, total))]
    return LaunchPlan(
        "bsn_sort", kernel_instance("bsn_sort_reg_kernel", code, _li(run)),
        _CSRC + "bsn_sort.cu:300", run, (blocks, 1, 1), elems // run,
        elems * size if L > 32 * run else 0, block=elems,
        operands=(Operand("in", total, size, span),
                  Operand("out", total, size, span, write=True)),
        int_offsets={"L": L, "elems": elems})


# flash_attention_launch's kernels (Geometry::kernel): the CUDA-core
# float32 one, the mma.sync bf16 one (D 16, 32), the wgmma bf16 one
FLASH_KERNELS = {0: ("flash_fwd_kernel", 889),
                 1: ("flash_fwd_mma_kernel", 702),
                 2: ("flash_fwd_wgmma_kernel", 276)}


def flash_kernel_code(D: int, bf16: bool) -> int:
    """The kernel ``flash_geometry`` picks by dtype and head width."""
    return 0 if not bf16 else 1 if D <= 32 else 2


def flash_stage_offsets(D: int) -> list[int]:
    """WgLayout<D>'s byte offsets (from the 1024-aligned base) of the q
    tile's and each stage's K and V tiles' boxes: 64-column boxes, then
    D 80's 16-column one."""
    bq, bk = _FL["WG_BQ"], _FL["WG_BK"]
    n64, n16 = D // 64, D % 64 // 16

    def boxes(start, rows):
        return ([start + c * rows * 128 for c in range(n64)]
                + [start + n64 * rows * 128] * n16)
    offs = boxes(0, bq)
    for st in range(_FL["WG_STAGES"]):
        k0 = bq * D * 2 + st * 2 * bk * D * 2
        offs += boxes(k0, bk) + boxes(k0 + bk * D * 2, bk)
    return offs


def flash_smem(D: int, bf16: bool) -> int:
    """The dynamic shared memory of the kernel the launch picks:
    WgLayout<D>::BYTES, TcLayout<D>::BYTES or the float32 smem_bytes(D)."""
    code = flash_kernel_code(D, bf16)
    if code == 2:
        bar = (_FL["WG_BQ"] * D * 2
               + 2 * _FL["WG_STAGES"] * _FL["WG_BK"] * D * 2)
        return 1024 + bar + 8 * (1 + 3 * _FL["WG_STAGES"])
    if code == 1:
        st = D + 8
        return 2 * (_FL["TC_BQ"] * st + 2 * _FL["TC_STAGES"] * _FL["TC_BK"]
                    * st)
    return 4 * (_FL["BK"] * (D + 4) + _FL["BK"] * D
                + _FL["BQ"] * (_FL["BK"] + 1))


def flash_attention_plan(*, B: int, S: int, Hq: int, Hkv: int, D: int,
                         bf16: bool = True,
                         causal: bool = True) -> LaunchPlan:
    """flash_attention_launch: ``flash_fwd_wgmma_kernel`` (bf16, D 64, 80,
    128), ``flash_fwd_mma_kernel`` (bf16, D 16, 32) or
    ``flash_fwd_kernel`` (float32), grid (B Hq, q tiles), the longest
    tiles first.  The wgmma kernel's TMA boxes reach past S, but TMA
    zero-fills those rows and reads nothing there."""
    code = flash_kernel_code(D, bf16)
    bq, bk, threads = {0: (_FL["BQ"], _FL["BK"], _FL["THREADS"]),
                       1: (_FL["TC_BQ"], _FL["TC_BK"], _FL["TC_THREADS"]),
                       2: (_FL["WG_BQ"], _FL["WG_BK"],
                           _FL["WG_THREADS"])}[code]
    gy = _cdiv(S, bq)
    isz = 2 if bf16 else 4

    def rows(p):
        b, hq = p[0] // Hq, p[0] % Hq
        row0 = (gy - 1 - p[1]) * bq
        return b, hq, hq // (Hq // Hkv), row0, min(row0 + bq, S)

    def q_rng(p, sc):
        b, hq, _, r0, r1 = rows(p)
        base = (b * S * Hq + hq) * D
        return [(base + r0 * Hq * D, base + (r1 - 1) * Hq * D + D)]

    def kv_rng(p, sc):
        b, _, h, r0, _ = rows(p)
        k_end = min(S, r0 + bq) if causal else S
        k_hi = min(S, _cdiv(k_end, bk) * bk)
        base = (b * S * Hkv + h) * D
        return [(base, base + (k_hi - 1) * Hkv * D + D)]

    def lse_rng(p, sc):
        _, _, _, r0, r1 = rows(p)
        return [(p[0] * S + r0, p[0] * S + r1)]
    name, line = FLASH_KERNELS[code]
    return LaunchPlan(
        "flash_attention", kernel_instance(name, _li(D)),
        _CSRC + f"flash_attention.cu:{line}", code, (B * Hq, gy, 1),
        threads, flash_smem(D, bf16), block=bq,
        operands=(Operand("q", B * S * Hq * D, isz, q_rng),
                  Operand("k", B * S * Hkv * D, isz, kv_rng),
                  Operand("v", B * S * Hkv * D, isz, kv_rng),
                  Operand("out", B * S * Hq * D, isz, q_rng, write=True),
                  Operand("lse", B * Hq * S, 4, lse_rng, write=True)),
        probe=(_split_probe(B, Hq), (0, gy - 1)),
        int_offsets={"key": _cdiv(S, bk) * bk, "row0 + BQ": gy * bq,
                     "B * Hq": B * Hq},
        no_spills=bf16 and D in (64, 80))

