"""Hand-written Hopper kernels and their wrappers (the counterpart of the
JAX package's ``pallas_ops/``).

``LAUNCHES`` counts, per kernel name, the launches its wrapper made: a
run can show that its main path went through the kernels. Set it back
with ``LAUNCHES.clear()``.
"""

import collections

LAUNCHES: collections.Counter = collections.Counter()
