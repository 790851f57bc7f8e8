"""HLS-flavoured timing model for the streaming simulator.

A copy of :mod:`repro.rinn.hls`: initiation intervals from the reuse
factor, pipeline fill from line buffers, and the board differences of the
paper's §III.C.2 (the Pynq-Z2 build registers the dense output, the ZCU102
build does not).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TimingProfile:
    board: str = "zcu102"
    reuse_factor: int = 1
    bitwidth: int = 16            # ap_fixed<W,·> of the data path
    fifo_capacity: int = 4096     # generous: we *measure* demand, like cosim
    sigmoid_ii: int = 2           # LUT sigmoid initiation interval
    source_ii: int = 1            # input arrival rate (beats/cycle = 1/source_ii)
    output_register: bool = False # Pynq-Z2 buffers dense output (+1 latency)
    # profiling interference (Listing 2): every ``pf_period`` firings of a
    # profiled node cost ``pf_stall`` extra cycles
    pf_period: int = 16
    pf_stall: int = 1
    # §III.C.8: a wider adder nudging the schedule, as an II bump above a
    # threshold width (0 = disabled)
    bitwidth_ii_bump_threshold: int = 0

    def with_(self, **kw) -> "TimingProfile":
        return dataclasses.replace(self, **kw)


ZCU102 = TimingProfile(board="zcu102", output_register=False)
PYNQ_Z2 = TimingProfile(board="pynq_z2", output_register=True)

BOARDS = {"zcu102": ZCU102, "pynq_z2": PYNQ_Z2}
