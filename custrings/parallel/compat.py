"""shard_map with the varying-manual-axes check off.

The shard bodies here return values they make replicated themselves (a
psum, or a scalar pmax on merged outputs) under out_specs that declare
them replicated; the check cannot see that through the bodies' sorts and
gathers, so it stays off.
"""

import functools

from jax import shard_map as _raw


@functools.wraps(_raw)
def shard_map(*args, **kwargs):
    kwargs.setdefault("check_vma", False)
    return _raw(*args, **kwargs)
