"""The port's examples, each a module that runs on the CUDA card unless
given ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.design_space --width 4608
    PYTHONPATH=src python -m repro_torch.examples.train_qat --steps 300
    PYTHONPATH=src python -m repro_torch.examples.serve_sc --smoke

Ports of the repository's ``examples/`` (``serve_sc``: its ServeEngine
part; the exported-TNN part needs the QAT MLP trainer of
``benchmarks/_qat_mlp.py``, which is not ported yet).
"""
