"""Ports of the softmax probes of ``benchmarks/`` (the JAX package's TPU
probes) to the H100: ``exp2_probe`` (the exp2 unit against a polynomial on
the FMA pipes), ``flash_mskip_ab`` (a flash forward that skips the
online-softmax rescale) and ``flash_poly_ab`` (the flash kernels built with
the polynomial exp2). Each runs as ``python -m ddti_tpu_torch.probes.<name>``
on the card, or with ``--device cpu`` through the plain versions, with no
times."""
