"""Baseline implementations for cross-checking and speed comparison.

The reference's 18 CasADi+IPOPT baselines (`traoptlibrary/traopt_baseline.py`)
cannot run on an accelerator (and casadi is not installed here); this
package provides
(a) a faithful serial-numpy mirror of the reference's own MS-iLQR execution
model, used as the wall-clock baseline proxy in bench.py, and (b) JAX-native
re-expressions of the embedded-Euclidean baseline families.
"""
