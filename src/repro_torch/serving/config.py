"""Validated construction surface for :class:`ServeEngine`.

Port of ``repro.serving.config.EngineConfig`` with the knobs the port
serves: slots, paging, chunking, datapath, KV format, the prefill mode,
speculative decoding and the serving mesh.  The port has no backend
knobs: a tensor's device decides whether a kernel or its plain version
runs, so the reference's rule against pinning a Pallas attention backend
under a mesh has nothing to bind to (under a mesh each rank runs the
same kernels on its own heads).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.kv_quant import KV_FORMATS
from ..distributed.sharding import MeshRules

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
    spec_decode: bool = False
    draft_len: int = 4
    # the serving mesh's rules (launch.mesh.serving_rules), or None
    mesh: MeshRules | None = None

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
        if self.mesh is not None and not isinstance(self.mesh, MeshRules):
            raise ValueError(f"mesh must be a MeshRules (launch.mesh."
                             f"serving_rules) or None, got "
                             f"{type(self.mesh).__name__}")
        if self.draft_len < 1:
            raise ValueError(f"draft_len must be >= 1 (a speculative "
                             f"round drafts at least one token), "
                             f"got {self.draft_len}")
        if self.spec_decode and self.datapath == "sc_int_approx":
            raise ValueError(
                "spec_decode drafts on the sc_int_approx datapath and "
                "verifies on the request's datapath: a sc_int_approx "
                "target makes the drafter the verifier; use "
                "datapath='qat' or 'sc_int'")
        return self
