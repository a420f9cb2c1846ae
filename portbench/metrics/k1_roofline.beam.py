"""K1's share of its roofline in the encode (K10's, when ``qk_int8``
routes the encode there): the op bound of its launch shape
(``counts.k1_bound``, visible slab pairs) over its device time, in %.

Reported in the beam-search submission cell."""

from portbench.metrics._common import k1_roofline as read  # noqa: F401
