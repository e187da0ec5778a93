"""sensor500 — the paper's own workload (Section IV-D / VI).

500 sensors uniform in [0,1]^2, thresholded Gaussian kernel weights
(theta = 0.074, kappa = 0.075), Chebyshev order K = 20 (K = 15 for the
lasso), SGWT with 6 wavelet scales.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphWorkloadConfig:
    name: str = "sensor500"
    n_vertices: int = 500
    theta: float = 0.074
    kappa: float = 0.075
    K: int = 20
    lasso_K: int = 15
    n_wavelet_scales: int = 6
    tau: float = 1.0
    r: int = 1
    noise_sigma: float = 0.5
    lasso_gamma: float = 0.2
    lasso_mu_wavelet: float = 0.75
    lasso_mu_scaling: float = 0.01
    lasso_iters: int = 300


CONFIG = GraphWorkloadConfig()
