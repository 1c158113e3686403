"""The paper's protocol evaluation on the port (the counterpart of the
repo's ``benchmarks/`` folder): ``protocol_micro`` holds the runners of
every section of ``BENCH_protocol.json`` and ``run.quick`` assembles them.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --quick \\
        [--device cpu] [--out PATH]
"""
