"""PyTorch/CUDA port of the AIF-Router fleet system (``repro`` is the JAX
reference it is held against).

Layout mirrors ``repro``: ``core`` (topology, policies, generative model,
belief, learning, agent, fused fleet tick, whole-window mega path),
``kernels.efe`` and ``kernels.attention`` (the CUDA C++ kernels for sm_90a
beside their plain PyTorch versions), ``envsim`` (batched fluid engine,
scenario library, the serving router), ``api`` (Router protocol,
closed-loop engine, declarative ``Experiment``), and the LM serving stack:
``models``, ``configs`` and ``serving``.

Entry points that create tensors take ``device=`` (default ``"cuda"``) and
raise ``RuntimeError`` when no card is present and ``device="cpu"`` was not
asked for.  Nothing here imports ``jax`` or ``repro``.
"""
