"""Collective communication of the MoE dispatch and combine: the substrate
registry and its transports on ``torch.distributed`` (``substrate.py``)
and the analytic bytes model (``cost.py``)."""
from repro_torch.comm import cost  # noqa: F401  (must precede substrate)
from repro_torch.comm.cost import (effective_chunks, ep_tier_groups,  # noqa: F401
                                   factored_ep, format_table, layer_cost,
                                   pipeline_time, step_cost, substrate_table,
                                   transport_cost, transport_time)
from repro_torch.comm.substrate import (COMM_KEYS, COUNTER, CommConfig,  # noqa: F401
                                        CommEnv, Transport,
                                        available_substrates, comm_zero,
                                        dequantize, get_substrate,
                                        make_transport, quantize,
                                        register_substrate)
