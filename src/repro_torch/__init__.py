"""repro_torch: the PyTorch/CUDA port of the De-VertiFL reproduction.

It mirrors the subpackages of the JAX package ``repro`` (each module
names the module it ports), runs on an NVIDIA H100, and never imports
JAX or ``repro``.  Entry point::

    from repro_torch.core.protocol import DeVertiFL, ProtocolConfig
    out = DeVertiFL(ProtocolConfig(dataset="mnist", n_clients=5)).train()

The federation runs on CUDA unless the caller passes ``device="cpu"``.
"""
