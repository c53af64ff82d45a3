"""hyperion_tpu_torch: the PyTorch/CUDA port of hyperion_tpu's transport
engine, for one NVIDIA H100.

It shares hyperion_tpu's JAX-free front end (``model``, ``dust``, ``grid``,
``sources``, ``util``, ``conf``) and replaces the JAX transport layer. The
JAX package stays the reference the port is tested against; this package
never imports JAX."""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, so that the kernels import without the model layer's h5py
    if name == 'run_model':
        from .model.run import run_model
        return run_model
    raise AttributeError(name)
