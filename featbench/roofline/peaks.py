"""Peak rates of one NVIDIA H100 SXM (80 GB HBM3, 700 W), from NVIDIA's
H100 data sheet (dense rates, no sparsity) unless marked ASSUMED."""

# HBM3 bytes per second
PEAK_BYTES = 3.35e12
# float32 operations per second on the CUDA cores
PEAK_F32 = 67e12
# float64 operations per second on the CUDA cores
PEAK_F64 = 34e12
# int8 tensor-core operations per second
PEAK_INT8_TC = 1979e12
# int32 compares (min / max) per second: 64 per clock and SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz, the clock behind the data sheet's 67 TFLOP/s
PEAK_INT32 = 64 * 132 * 1.98e9
# ASSUMED: 1-bit tensor-core operations (AND + POPC) per second.  The data
# sheet states no 1-bit rate; 8 x the int8 rate is the ratio the A100's
# data sheet states (4992 to 624 TOP/s).
PEAK_B1_TC = 8 * PEAK_INT8_TC
