"""SC numerics: level coding, quantizers, BSN adders, SC layers, KV formats."""
