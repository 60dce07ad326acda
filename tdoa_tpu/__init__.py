"""tdoa_tpu — a JAX/XLA TDOA radio-geolocation framework for one or more GPUs.

Re-implements the capabilities of the KX0U-Jim/tdoa-geolocation reference
system (RTL-SDR dual-frequency capture → cross-correlation → hyperbolic
positioning) as a batched, fused, JIT-compiled device pipeline:

- ``tdoa_tpu.io``       — the ``.dat`` capture codec ([REF|TGT|REF] u8 IQ
                          blocks) and ``lat-lon-table.csv`` station geometry
                          (reference contracts: processor.go:166-267,
                          processor.go:52-107).
- ``tdoa_tpu.sim``      — pure-JAX signal simulators with physically true
                          integer+fractional sample delays (capability of
                          simulator.go / weak_signal_simulator.go, with the
                          phase-only delay model fixed).
- ``tdoa_tpu.ops``      — batched FFT cross-correlation with GCC-PHAT
                          weighting, segmented coherent accumulation, and
                          sub-sample peak interpolation (replaces the
                          O(lag·N) loop at processor.go:646-736).
- ``tdoa_tpu.dsp``      — FIR filters, FM quadrature discriminator +
                          decimation (rtl_fm.c:427-544 capability),
                          windows, SNR estimation.
- ``tdoa_tpu.geo``      — WGS84/ECEF/ENU geodesy (processor.go:125-163,
                          1023-1045 semantics).
- ``tdoa_tpu.solve``    — Gauss-Newton / Levenberg-Marquardt hyperbolic
                          multilateration on all station pairs (replaces
                          processor.go:932-1020, which dropped the third
                          pair).
- ``tdoa_tpu.quality``  — data validation and signal-quality analysis
                          (reader.go / analyzer.go / fast_analyzer.go).
- ``tdoa_tpu.calib``    — closed-loop gain calibration
                          (gain_calibrator.go).
- ``tdoa_tpu.pipeline`` — the end-to-end capture→fix processor with
                          reference-signal clock-offset removal.
- ``tdoa_tpu.parallel`` — jax.sharding Mesh / shard_map scaling over the
                          segment and station-pair axes.
- ``tdoa_tpu.cli``      — command-line tools mirroring the reference
                          binaries (collector, reader, analyzer,
                          fast_analyzer, processor, simulator,
                          weak_signal_simulator, gain_calibrator,
                          simple_corr, correlation_sanity, snr_analysis).
"""

__version__ = "0.1.0"

from tdoa_tpu.utils.constants import SPEED_OF_LIGHT, DEFAULT_SAMPLE_RATE

__all__ = ["SPEED_OF_LIGHT", "DEFAULT_SAMPLE_RATE", "__version__"]
