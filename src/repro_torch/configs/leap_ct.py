"""The paper's own workloads: projection geometries from Table 1 and the
limited-angle experiment (512^2 image, 720-view parallel beam).  The same
geometries as the reference package's ``configs/leap_ct.py`` (equal
``to_config()`` and ``canonical_hash()``)."""
from repro_torch.core.geometry import VolumeGeometry, cone_beam, parallel_beam


def table1_geometries(reduced: bool = False):
    """The four Table-1 cells: (parallel|cone) x (512^3/180 | 1024^3/720).
    ``reduced`` scales to CPU-runnable sizes, keeping aspect ratios."""
    cells = {}
    for n, na in ((512, 180), (1024, 720)):
        nn, nna = ((n // 8, na // 6) if n <= 512 else (n // 16, na // 12)) \
            if reduced else (n, na)
        vol = VolumeGeometry(nn, nn, nn)
        cells[f"parallel_{n}_{na}"] = parallel_beam(
            nna, nn, int(nn * 1.5), vol, angular_range=180.0)
        cells[f"cone_{n}_{na}"] = cone_beam(
            nna, nn, int(nn * 1.5), vol, sod=2.0 * nn, sdd=4.0 * nn,
            pixel_width=2.0, pixel_height=2.0, angular_range=360.0)
    return cells


def limited_angle_geometry(n: int = 512, n_angles: int = 720):
    """The limited-angle training shape: an n x n x 1 volume, ``n_angles``
    views over 180 degrees, a 1 x 1.5n detector."""
    vol = VolumeGeometry(n, n, 1)
    return parallel_beam(n_angles, 1, int(n * 1.5), vol, angular_range=180.0)
