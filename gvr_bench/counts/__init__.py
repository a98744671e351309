"""Operations and bytes of the measured work, from shapes alone.

Each count reads every input once and writes every output once, over the
rows' real lengths, as the port's chip script bounds its kernels
(`chip_smoke.bound_ms`): a kernel or a step cannot take less time than the
larger of its operations over the chip's peak rate and its bytes over the
memory's rate (`h100.py`).
"""
