"""PyTorch port of the Zebra reproduction (``repro``), module for module.

Each module keeps the path and public names of its counterpart in
``repro``; inside, it is PyTorch: ``nn.Module``s, plain functions on
tensors, an explicit ``device`` and explicit ``torch.Generator``s. The
package imports ``torch`` and never ``jax``, and nothing of ``repro``.

The Pallas kernels of the compressed ``stream`` backend are CUDA C++
kernels for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.
Each has a plain PyTorch version beside its wrapper, which the wrapper
takes only for tensors on the CPU.
"""
