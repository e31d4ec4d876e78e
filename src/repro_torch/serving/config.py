"""Validated construction surface for :class:`ServeEngine`.

Port of ``repro.serving.config.EngineConfig`` with the knobs the port
serves: slots, paging, chunking, datapath, KV format and the prefill
mode.  The reference's backend knobs, mesh rules and speculative decoding
are not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.kv_quant import KV_FORMATS

__all__ = ["DATAPATHS", "EngineConfig"]

DATAPATHS = ("qat", "sc_int", "sc_int_approx")


@dataclass(frozen=True)
class EngineConfig:
    """Every serving knob of :class:`~repro_torch.serving.ServeEngine`;
    defaults are the reference's."""
    max_slots: int = 4
    max_len: int = 256
    page_size: int = 16
    num_pages: int | None = None
    prefill_chunk: int = 64
    datapath: str = "qat"
    kv_format: str = "fp"
    prefill_mode: str = "chunked"

    def validate(self) -> "EngineConfig":
        """Raise ``ValueError`` on the first violated rule; return self."""
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2 (one prompt token + "
                             f"one generated token), got {self.max_len}")
        if self.page_size < 1 or self.page_size & (self.page_size - 1):
            raise ValueError(f"page_size must be a power of two, "
                             f"got {self.page_size}")
        if self.num_pages is not None and self.num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the "
                             f"reserved trash page), got {self.num_pages}")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {self.prefill_chunk}")
        if self.datapath not in DATAPATHS:
            raise ValueError(f"datapath must be one of {DATAPATHS}, "
                             f"got {self.datapath!r}")
        if self.kv_format not in KV_FORMATS:
            raise ValueError(f"kv_format must be one of {KV_FORMATS}, "
                             f"got {self.kv_format!r}")
        if self.kv_format == "sc" and self.datapath == "qat":
            raise ValueError(
                "kv_format='sc' keeps the cache on the SC coding and pairs "
                "with the SC datapaths only: use datapath='sc_int' or "
                "'sc_int_approx', or kv_format='int8'/'fp' with 'qat'")
        if self.prefill_mode not in ("chunked", "exact"):
            raise ValueError(f"prefill_mode must be 'chunked' or 'exact' "
                             f"(the per-request oracle), got "
                             f"{self.prefill_mode!r}")
        return self
