"""The parallel modes (``frankenstein_tpu/parallel``): the (data, model)
mesh and its collectives, tensor- and expert-parallel sharding, GPipe and
ring attention, over ``torch.distributed``."""
