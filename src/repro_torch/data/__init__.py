from repro_torch.data.phantoms import (analytic_parallel_projection,
                                      random_ellipse_phantom, shepp_logan_2d)

__all__ = ["random_ellipse_phantom", "shepp_logan_2d",
           "analytic_parallel_projection"]
