"""The paper's own silicon workload (§II-C): a ternary MLP for 10-way
MNIST-class classification, the 28-nm chip's network (98.28% soft
accuracy).

Layer sizes follow the DATE'20 / SSCL'22 TNN processor (784-256-256-10,
all ternary, BSN + SI activations).  Not part of the LM zoo: the
fault-tolerance study (Fig 5) and the exported-TNN datapath use it.
"""

TNN_LAYERS = (784, 256, 256, 10)
TNN_ACT_BSL = 2          # the chip's fully ternary datapath
TNN_RESID_BSL = 16       # the §III residual extension
