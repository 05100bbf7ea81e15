"""Examples of the port, each run as ``python -m repro_torch.examples.<name>``
(the counterparts of the JAX package's ``examples/``): ``quickstart``,
``train_llm``, ``serve_aida`` and ``aida_emulator_demo``.  Each runs on the
card unless ``--device cpu`` asks for the plain versions."""
