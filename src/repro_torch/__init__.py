"""PyTorch/CUDA port of the AIF-Router fleet system (``repro`` is the JAX
reference it is held against).

Layout mirrors ``repro``: ``core`` (topology, policies, generative model,
belief, learning, agent, fused fleet tick), ``kernels.efe`` (the fused
belief→EFE kernel in CUDA C++ for sm_90a plus its plain PyTorch version),
``envsim`` (batched fluid engine and scenario library) and ``api`` (Router
protocol, closed-loop engine, declarative ``Experiment``).

Entry points that create tensors take ``device=`` (default ``"cuda"``) and
raise ``RuntimeError`` when no card is present and ``device="cpu"`` was not
asked for.  Nothing here imports ``jax`` or ``repro``.
"""
