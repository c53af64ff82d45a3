"""hyperion_tpu_torch: the PyTorch/CUDA port of hyperion_tpu, for one
NVIDIA H100.

It owns a copy of hyperion_tpu's JAX-free front end (``model``, ``dust``,
``grid``, ``sources``, ``util``, ``conf``, ``filter``; each copy is held to
its original by ``tests/test_torch_frontend.py``) and replaces the JAX
transport layer. It imports neither JAX nor anything of hyperion_tpu, which
stays the reference the port is tested against. Entry points run on the
card unless the caller passes ``device='cpu'``::

    from hyperion_tpu_torch.model import Model
    m = Model()
    ...
    m.write('model.rtin')
    m.run('model.rtout')            # or m.run(..., device='cpu')
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, as hyperion_tpu does: importing the package stays light
    if name in ('Model', 'ModelOutput', 'run_model'):
        from . import model
        return getattr(model, name)
    raise AttributeError(name)
