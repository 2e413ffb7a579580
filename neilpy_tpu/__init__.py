"""neilpy_tpu — a terrain analysis and lidar point-cloud processing
framework built on JAX/XLA/Pallas.

A from-scratch rebuild of the capabilities of ``neilpy``
(thomaspingel/neilpy) with an accelerator-first architecture: fused stencil
scans for openness/geomorphons, scatter-reduce point gridding,
matrix-free CG inpainting, exact disk morphology for SMRF, moment-form
bicubic splines, sliding-sum raster statistics, and a
shard_map halo-exchange layer for multi-device meshes — plus its own
pure-Python GeoTIFF/LAS/worldfile I/O and a numpy projection engine.

The public namespace mirrors the reference's API surface
(reference neilpy/__init__.py:1) so existing neilpy workflows port
directly, and adds its own extensions (Raster, halo/dist,
Moran's I, bench kernels).
"""

__version__ = "0.1.0"

# ----- core -----------------------------------------------------------
from .core.affine import Affine, from_origin
from .core.grid import (Raster, keep_xyz, edges_from_IT, unique_rows,
                        cutter, normalize)
from .core.shift import ashift, gradient2d
from .core.codes import (int2base, get_lowest_equivalent,
                         terrain_code_to_geomorphon, progressive_window,
                         disk, distance_kernel, geomorphon_cmap,
                         geomorphon_cmap_old)

# ----- I/O ------------------------------------------------------------
from .io.geotiff import (imread, imwrite, read_geotiff, write_geotiff,
                         GeoTiffSource)
from .io.las import read_las, write_las
from .io.worldfile import write_worldfile
from .io.png import write_paletted_png
from .io.text import read_isprs, read_xyz

# ----- surface ops ----------------------------------------------------
from .ops.surface import (esri_slope, slope, aspect, curvature,
                          esri_curvature,
                          zevenbergen_and_thorne_curvature,
                          evans_curvature, wilson_gallant_curvature,
                          hillshade, multiple_illumination, pssm,
                          z_factor, triangle_height, vip_score, std,
                          std2, reduce_peaks,
                          topographic_position_index,
                          scaled_morphometry)

# ----- visibility / geomorphons --------------------------------------
from .ops.visibility import (openness, openness_pair, skyview_factor,
                             count_openness,
                             geomorphons, geomorphons2,
                             ternary_pattern_from_openness,
                             get_geomorphons, get_geomorphon_from_openness)

# ----- point cloud pipeline ------------------------------------------
from .ops.pointgrid import (create_dem, create_dem_from_las,
                            bin_points)
from .ops.inpaint import (inpaint_nans_by_springs, inpaint_nans_by_fda,
                          inpaint_nearest, inpaint_nearest_device)
from .ops.morphology import (grey_erosion_disk, grey_dilation_disk,
                             opening_disk, opening, erosion, dilation)
from .ops.spline import interp_spline_2d
from .pipelines.smrf import smrf, smrf_las, progressive_filter
from .dist.tiling import tiled_apply, apply_parallel, TileCheckpoint

# ----- statistics -----------------------------------------------------
from .ops.stats import (gi_formula, gistar_formula, rasterGi, morans_i,
                        local_morans_i, rmse, score, shi_landslides, bdr,
                        chamfer_distance, hungarian_algorithm,
                        bdr_bootstrap)

# ----- visualization --------------------------------------------------
from .viz.shading import (swiss_shading, colortable_shade, swiss_lut,
                          brassel_atmospheric_perspective, corner_lut,
                          lut_shade)

# ----- geodesy / photogrammetry --------------------------------------
from .geo.proj import (coord_transform, great_circle_distance,
                       geodesic_inverse, utm_forward, utm_inverse)
from .geo.geoid import (geoid_height, ellipsoidal_to_orthometric,
                        orthometric_to_ellipsoidal)
from .photo.gnss import (read_llh, read_pos, stringify_time,
                         fix_gopro_bad_time_resolution,
                         fix_gopro_bad_time_resolution2, posprocessor,
                         track2azimuth, ypr2opk)
from .photo.exif import (exif_dict_to_dd, dd_to_exif_tuple,
                         read_geotags_into_df, ppk_images)

# ----- misc -----------------------------------------------------------
from .utils import voxelize, write_voxel_stl, set_print_options

# Compatibility: the reference exposes its install directory as a
# module global for locating packaged assets (neilpy.py:83, via an
# inspect.stack() hack).  This framework's LUTs are procedural, so
# nothing here *needs* the path, but user code that referenced
# ``neilpy_dir`` keeps working against the package directory.
import os as _os
neilpy_dir = _os.path.dirname(_os.path.abspath(__file__))
del _os

# ----- observability ---------------------------------------------------
from .profiling import Throughput, trace, compile_report

# ----- runtime: backend choices and the opt-in executable cache --------
from . import aot, backend

# ----- multi-device / out-of-core ---------------------------------------
from . import dist
from .pipelines.mosaic import mosaic_terrain_products
