"""Multi-device and multi-process parallelism for the ``.znn`` codec.

The counterpart of the JAX package's ``parallel/``.  The format is
chunk-parallel by construction: every (plane, chunk) cell is an
independent stream with a known output offset.  :mod:`.sharded` splits
one container's chunks over the devices of a :class:`~.sharded.Mesh` in
one process; :mod:`.multihost` lets several processes (``torchrun``, or
``multihost.initialize`` by hand, on ``torch.distributed`` with gloo)
compress and decompress one file together, each reading only its chunk
range.

Usage::

    mesh = parallel.make_mesh()            # every CUDA device
    with parallel.use_mesh(mesh):
        ZipNN(engine="cuda").compress(...)  # kernels split over the mesh
"""
from . import multihost  # noqa: F401
from .sharded import (  # noqa: F401
    Mesh,
    get_default_mesh,
    make_mesh,
    sharded_combine,
    sharded_decode_streams,
    sharded_encode_streams,
    sharded_histogram,
    sharded_split,
    use_mesh,
)
