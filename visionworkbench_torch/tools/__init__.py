"""Tools of the port, each the JAX package's CLI of the same name with
``main(argv=None, device=None)`` (``None`` = the card; run as ``python -m
visionworkbench_torch.tools.<name>``): correlate, ipfind, ipmatch,
image2qtree, undistort_image, hillshade, colormap, print_exif,
convert_pinhole_model, georef_query, and the flood suite (``flood/``,
detect_water, clean_sentinel1_borders, sentinel1_flood_detect,
extract_modis); and measurement tools run on a CUDA card from the
repository root (``frame_times`` and the kernel ablations)."""
