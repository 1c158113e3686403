"""The plain float32 reference of the trained configurations.

Plain PyTorch, written from the architectures' equations and the port's
stated choices (routing with capacity, the bounded RWKV decay, the
stacked layers' optimizer state), with no kernel, no cache and no
batching trick: ``qwen3`` (the dense and the MoE Qwen3 blocks), ``rwkv6``
(the Finch block) and ``optim`` (AdamW, Adafactor).  ``train.train``
takes the benchmark's weights and batches through the first steps and
returns the readings that ``correct`` compares.  A model's module is
found by the configuration's ``reference`` name (``train.module``), so a
new architecture's reference is a new file here.

It imports neither ``jax``, ``repro`` nor ``repro_torch``, and it works
out from the weights and the batches everything the program derives.
TF32 is off while it runs (``common.float32_matmuls``).
"""
