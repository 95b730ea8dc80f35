"""Quality metrics of predicted fields (paper Eqs. 2-4 and PSNR)."""
from repro_torch.metrics.image import psnr
from repro_torch.metrics.physics import (mixing_layer_thickness, timeseries_correlation,
                                         total_mass, total_momentum)

__all__ = ["total_mass", "total_momentum", "mixing_layer_thickness",
           "timeseries_correlation", "psnr"]
