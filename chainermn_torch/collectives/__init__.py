"""Pluggable gradient-reduction strategies: the reference's communicator
zoo as reduction algorithms over the port's communicators. Counterpart of
``chainermn_tpu/collectives/``::

    reducer = make_grad_reducer("hierarchical", comm, intra=4)
    opt = create_multi_node_optimizer(torch.optim.Adam(...), comm,
                                      grad_reducer=reducer)  # or the name

Strategies: ``flat`` (the numerical reference), ``hierarchical``,
``quantized`` (error feedback), ``auto`` (cost model), ``synth`` (a
synthesized per-tier program from :mod:`chainermn_torch.synthesis`;
``make_grad_reducer("synth", comm, program=...)``). ``wire_format=``
(``'f32' | 'bf16' | 'int8' | 'int8-block' | 'int4-block'``) selects what
the compressing strategies put on the wire.
"""

from chainermn_torch.collectives.auto import (AutoReducer, CostModel,
                                              measure_strategies)
from chainermn_torch.collectives.base import (REDUCERS, WIRE_FORMATS,
                                              GradReducer,
                                              make_grad_reducer,
                                              register_reducer)
from chainermn_torch.collectives.flat import FlatReducer
from chainermn_torch.collectives.hierarchical import (HierarchicalReducer,
                                                      HierTopology)
from chainermn_torch.collectives.quantized import (QUANT_BLOCK,
                                                   QuantizedReducer,
                                                   block_dequantize,
                                                   block_quantize,
                                                   collective_wire_bytes,
                                                   pack_int4,
                                                   quantize_allreduce,
                                                   quantized_wire_bytes,
                                                   unpack_int4, wire_ratio)

__all__ = ["GradReducer", "make_grad_reducer", "register_reducer",
           "REDUCERS", "WIRE_FORMATS", "FlatReducer", "HierarchicalReducer",
           "HierTopology", "QuantizedReducer", "quantize_allreduce",
           "QUANT_BLOCK", "block_quantize", "block_dequantize", "pack_int4",
           "unpack_int4", "wire_ratio", "quantized_wire_bytes",
           "collective_wire_bytes", "AutoReducer", "CostModel",
           "measure_strategies", "SynthesizedReducer"]

# last: registers the 'synth' strategy (it imports collectives.base)
from chainermn_torch.synthesis.compiler import (  # noqa: E402  # isort: skip
    SynthesizedReducer)
