"""The example programs (ports of ``examples/``), each a ``main()`` with the
JAX example's flags and printed lines. Run one as a module from the
repository's root, ``python -m mila_tpu_torch.examples.mnist_train``.

They run on the device of ``runtime.default_context()``: the GPU, unless
the caller set another context (``set_default_context(ExecutionContext(
"cpu"))``, as the tests do); ``mnist_train`` takes ``--device`` as JAX's
does.
"""
