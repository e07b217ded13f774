"""PyTorch / CUDA port of the Protocol Learning reproduction.

A second package beside the JAX reference (``repro``): it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.  Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a CUDA C++ kernel for
Hopper (``csrc/``), built with ``nvcc`` at first use and bound with ctypes
(``kernels/``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; they raise when CUDA is missing and the CPU was not asked
for (``device.resolve_device``).

Ported so far: the centralized synchronous swarm round on the dense
protocol-125m LM — configs, data, the dense transformer, optimizers,
masked aggregation, the QSGD wire, audits, the ledger and the ``Swarm``
engine — with the four masked-aggregation / QSGD-decode kernels (slice
1); Protocol Model serving on h2o-danube-1.8b with the sliding-window
attention kernel (slice 2); rwkv6-1.6b served through the same server,
with the WKV recurrence kernel (slice 3); zamba2-1.2b served through it,
with the Mamba2 SSD scan kernel (slice 4).
"""
