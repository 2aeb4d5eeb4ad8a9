"""Ports of the TPU probes of ``benchmarks/`` (the JAX package's) to the
H100: the softmax probes ``exp2_probe`` (the exp2 unit against a polynomial
on the FMA pipes), ``flash_mskip_ab`` (a flash forward that skips the
online-softmax rescale) and ``flash_poly_ab`` (the flash kernels built with
the polynomial exp2); ``pallas_conv_probe`` (a fused conv3x3 + bias + ReLU
against cuDNN); and the warp-gather probes ``gather_probe``,
``gather_probe2`` and ``gather_probe3`` (one gather kernel, three modes,
beside torch.gather). Each runs as ``python -m
ddti_tpu_torch.probes.<name>`` on the card, or with ``--device cpu``
through the plain versions, with no times."""
