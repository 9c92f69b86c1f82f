"""The port's runnable examples: one for each of the JAX package's
`examples/NN_name.py`, under the same name, with the same `main(...)`
arguments and a `device=` (CUDA by default; it raises without CUDA
unless ``"cpu"`` is asked). Run one as a module:

    python -m deeplearning4j_tpu_torch.examples.01_quickstart_mlp
    python -m deeplearning4j_tpu_torch.examples.01_quickstart_mlp --device cpu

`README.md` lists them.
"""
