"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3) at its full power
limit of 700 W, which the roofline shares are stated against.

* HBM: 3.35 TB/s (NVIDIA's H100 data sheet).
* 32-bit integer multiplies: 16.75e12 a second. The data sheet's 67
  TFLOP/s in float32 are 128 fused multiply-adds a clock on each of the
  132 SMs at 1.98 GHz; the CUDA C++ Programming Guide's table of
  arithmetic throughput gives compute capability 9.0 half as many 32-bit
  integer multiplies (64 a clock an SM, each one 32-bit result).
* NVLink between cards: 450e9 bytes a second each way. The data sheet's
  900 GB/s of NVLink 4 (18 links) count both directions.
"""

HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 67e12 / 2 / 2
LINK_BYTES_PER_S = 900e9 / 2
