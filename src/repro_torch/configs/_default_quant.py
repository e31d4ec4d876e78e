"""Default SC quantization: the paper's co-design applied as W2-A8-R16
(ternary weights, BSL-8 activations, BSL-16 residual), as in the
reference's ``configs/_default_quant.py``."""

from ..core.sc_layers import SCQuantConfig

DEFAULT_SC = SCQuantConfig(mode="sc_qat", weight_bsl=2, act_bsl=8,
                           resid_bsl=16, per_channel=True)
