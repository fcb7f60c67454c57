from . import (block_tridiag, dft, edge_flow, fourier_ao, karhunen_loeve,
               newton_kkt, phase_screens, phase_stats, psf, psf_kernel,
               raytrace, relay, segmented, telescope_optics, toeplitz,
               zernike, zernike_stats)
