"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on a mismatch; none catches its own failure):

1. Build the CUDA kernels from ``visionworkbench_torch/csrc/`` (one nvcc per
   source, started together), print each build's registers and spills (and
   fail if an instance of the register-carry SGM/MGM kernel that the
   wrappers can select, of the path-line SGM kernel, of the MGM cluster
   kernel -- every cell count and mode -- or of the
   sweep's band kernels -- abs/sq/NCC and census, 1 and 2 words, every K --
   or of the speckle stencil -- every rows-a-pass instance -- or of the
   winner-take-all step -- its register instances for 4-32 cells and its
   wide variant -- spills), and
   print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: the sweep and speckle on inputs quantized
   to the 1/256 grid (integer disparities, validity, cost patches and keep
   masks exact) -- the sweep with abs and census 5x5 costs at the bench and
   config-4 shapes (levels 4 to 0 and the level-0 R->L pass; the abs cases,
   and one sq case, on ``band_sweep_kernel``, the census ones on
   ``band_census_kernel``, each also against ``sweep_kernel<cost, words>``
   and also on off-grid inputs, the bench texture, where the summation
   order shows and the codes have structure across band boundaries),
   ternary census 7x7 at level 0 (the census band kernel), NCC on
   ``band_sweep_kernel`` at every level of the bench frame without the ring
   and its level-0 R->L pass (each also against ``sweep_kernel<2,1>``, level
   0 with black blocks in both frames, so zero-energy windows give NaN
   metrics), NCC and the full-frame census 7x7 codes at config 3's shape
   (black blocks too; the code planes' sweep also against
   ``sweep_kernel<3,2>``), a tile of 128 at level 1's shape (NCC with black
   blocks and census, on the band kernels and against ``sweep_kernel``,
   which runs its pixels in rounds), the entry points of the
   first-generation sweeps (``ops/cost_volume.py``, on the band kernel),
   and the abs sweep at every level of the correlate CLI's frame (21x21:
   ``band_sweep_kernel<abs, 24>``, level 0 without and with the ring);
   the speckle stencil at level 0's 11x11 window on 1024^2 and on an odd
   1000x777 frame, a coarse level's 3x3, a window with ``hh != hv`` and a
   frame smaller than a block -- and the three
   SGM/MGM scans on integer-valued inputs (exact). The three scans run the
   register-carry kernel (``csrc/mgm_scan.cu``) at every shape of config
   6's pyramid; ``scan_bidir`` runs the path-line kernel
   (``csrc/sgm_path_scan.cu``) at ``calc_disparity_sgm``'s 64x8 search (x-
   and y-scan) and an odd 3x11 grid; each is held against the plain version
   and against ``line_scan_kernel<0>`` (``scan_bidir``) or ``<1>`` (MGM) on
   the same inputs; the MGM scans past the register-carry kernel's limits
   run a cluster a line: both at the 64x8 search on 256^2 and the three of
   the one-level 64x2 search on 64x512 on ``csrc/mgm_cluster_scan.cu``,
   both at config 6's level 0 on 1024^2 (1024 lanes) on the register-carry
   kernel over a cluster of blocks (the launch counts show which kernel
   ran). The winner-take-all step (``csrc/sgm_wta.cu``, one launch a call)
   equals its plain version word for word in every subpixel mode, on
   tie-rich and on distinct integer costs with absent candidates, at
   asp-mgm's level 0 (1536^2, 3 x 5), config 6's levels and
   ``calc_disparity_sgm``'s 64x8 search (the wide variant), and on every
   volume that config 6's MGM frame and ``calc_disparity_sgm(use_mgm=True)``
   hand it.
3. Run the main paths, each with the launch counts set to 0 just before it
   and read just after (the winner-take-all step once a level of an SGM or
   MGM pyramid, once a ``calc_disparity_sgm``): ``pyramid_correlate`` at the configuration of
   ``bench.py`` (1024^2 pair, 64x8 search, 15x15 kernel, 4 levels, tile 64,
   parabola), again with the L<->R check, then the repo's SGM configuration
   (``tools_bench_configs.py`` config 6: 512^2 pair, 64x2 search, census
   5x5, 4 levels, tile 64, parabola) with ``stereo_algorithm="sgm"`` and
   ``"mgm"``, and ``calc_disparity_sgm`` as ``docs/stereo.md`` calls it
   (64x8 search, census 5x5, parabola) on a 256^2 frame (the SGM frame's
   10 ``scan_bidir`` launches all on the register-carry kernel, the 2 of
   ``calc_disparity_sgm`` on the path-line kernel), the same call with
   ``use_mgm=True`` (its 2 ``mgm_bidir`` and 1 ``mgm_fwd`` on the cluster
   kernel) and config 6's MGM pyramid on the bench's 1024^2 pair (level 0's
   three scans a cluster a line, the 12 of levels 1-4 a block a line; none
   of the 512^2 MGM frame's a cluster a line); config 4 (the
   bench frame with census 5x5 costs, ``tools_bench_configs.py:166-182``)
   without and with the L<->R check, and with ternary census 7x7; the
   bench frame with NCC costs without and with the L<->R check;
   ``calc_disparity`` at config 3 (``tools_bench_configs.py:150-164``:
   1024^2, 32x1 search, 15x15, the right frame edge-padded by 31 columns)
   with abs, ncc and census 7x7 costs; and the entry points of TPU kernels
   6 and 7 on config 3's frames; then cli-log-1024, the correlate CLI's
   defaults (``visionworkbench_tpu/tools/correlate.py:20-60``: 21x21
   kernel, LoG prefilter of width 1.4, 5 levels, tile 64, speckle 5,
   subpixel none) on the bench pair and search box, again with the
   parabola, with ``keep_levels`` (six level maps of the right shapes, the
   final map the plain run's), with ``blob_filter_area=64`` and with a
   ``corr_timeout`` at the port's own measured s/op that degrades level 0
   alone (printing each level's search and sweep kernel); config7-em-1024,
   the repo's config 7 (``tools_bench_configs.py:256-275``: census 5x5,
   7x7, 4 levels, tile 64, the Bayes-EM refiner) on its texture in
   ``bench.py``'s orientation, and its ``subpixel="affine"`` variant;
   cli-em-1024, the port's correlate CLI (``tools/correlate.py``) with
   ``--subpixel em`` on the bench pair written as TIFFs, the output TIFF
   read back (its wall time printed); apply ``bench.py``'s sanity check to
   each (every abs and NCC sweep launch on ``band_sweep_kernel``, every
   census one on ``band_census_kernel``, none on ``sweep_kernel``); then
   config5-mosaic-1024, the repo's config 5 (``tools_bench_configs.py:
   184-230``: four 614^2 sources of the texture of seed 11 at their
   diagonal georefs, reprojected into a 1024^2 canvas at scale 0.01 and
   multiband-blended over 4 levels, plans made once) through
   ``mosaic.geomosaic.reproject_mosaic``: no kernel of ``csrc/`` launched,
   every source on the 1-D coordinate route, ``valid`` equal to the union
   of the plans' masks, the mosaic finite and, wherever one source alone
   covers every pixel within 2^(levels + 2) px, equal to that source's
   warp within 1e-4; then config1-1024 (``tools_bench_configs.py:113-126``:
   the Gaussian blur of sigma 1.5 and 4 blur-downsamples on the texture of
   seed 11; no ``csrc/`` launch, card = CPU bit for bit at every level),
   config2-1024 (``:128-148``: upright single-scale Harris, 512 points,
   threshold 1e-8, upright sgrad, ratio 0.8, on both images of the pair
   shifted by 16 px; no ``csrc/`` launch; >= 0.9 of the ok matches within
   0.5 px of the shift; card against CPU: ``_peaks_to_points`` on one
   response map equal, >= 0.99 of the CPU's points within 1e-3 px, ok match
   counts within 1 %) and cli-match-1024, the chain a user runs on the bench
   pair with the right image rotated by 1 degree, as float32 TIFFs:
   ``tools/ipfind.py`` (harris, single scale), ``tools/ipmatch.py``
   (similarity RANSAC) and ``tools/correlate.py --match-file`` (the CLI
   frame's sweeps on ``band_sweep_kernel`` and speckle, counted), >= 0.9 of
   the valid interior within 0.5 px of the true map's disparity (0 after a
   true pre-alignment) and the fitted pre-alignment within 0.3 px of the
   true map; the CLI once more on an exact match file (200
   correspondences, 50 outliers: 200 inliers printed, pre-alignment within
   0.05 px); and the chain on ipmatch's (left, right) file, which the
   pre-alignment followed from the JAX package does not align (ROADMAP
   section 3): it must fail the 0.9 gate, so the check fails once that
   defect is fixed; then config8-1024 (``:277-295``: ``detect_sift_like``
   -- the DoG detector at 512 points, 1008 slots, orientations and
   oriented descriptors -- on both images of config 2's pair, ratio 0.8;
   no ``csrc/`` launch; >= 50 ok matches, >= 0.9 of them within 0.5 px of
   (16, 0); card against CPU: ``detect_points_dog`` at 1024^2 equal, scale
   within 1e-6; both routes of ``detect_sift_like`` (``VWTPU_SIFT_GATHER``
   0 and 1) at 512^2 with the points equal, >= 0.99 of the orientations
   within 1e-4 rad and >= 0.99 of their descriptors within 1e-4, the ok
   match counts within 1 %; ``detect_points_obalog`` at 256^2, >= 0.99 of
   the CPU's points within 1e-3 px) and ipfind's SIFT-class chains on
   cli-match's TIFFs, CPU first, then the card: ``ipfind`` with its
   default operator (sift) and ``ipmatch right left`` at its default ratio
   (counts only: too few matches to pre-align), the same at ratio 0.8, and
   ``ipfind --interest-operator obalog``; each gated chain's pre-alignment
   within 0.3 px of the true map (or the CPU's error + 0.05 px).
4. Run the slices small on the card and on the CPU (plain versions): the
   mosaic slice at 256^2 (config 5: ``valid`` equal, values within 1e-5;
   ``warp_from_grid`` on both coordinate routes and ``transform`` with a
   rotation within 1e-5; the device grassfire of config 5's masks at
   1024^2 and 256^2 equal to ``grassfire_np``); the
   quality-subpixel slice at 256^2 (config 7's frame with the EM and the
   affine refiner and ``bayes_em_subpixel`` over its own 2-level pyramid:
   validity agreeing on >= 99.5 % of pixels and a share of pixels within a
   bound, the pyramid's beside its one-ulp sensitivity on the CPU, in both
   modes of ``VWTPU_EM_REWARP``;
   ``lk_subpixel``, ``phase_subpixel``, ``corr_eval``, ``interpolate`` in
   three modes and the decimation, equal or within 1e-4); the CLI frame's
   path at 256^2 on the bench texture (the LoG-prefiltered
   pyramids, whole LoG frames -- every level's map, also with the blob
   filter -- and ``remove_small_blobs``, all equal); then on quantized
   inputs: BM at 256^2 with 2 levels (integer disparities and
   validity equal, the parabola output allclose at atol 1e-4), the same BM
   run with left and right masks (integer disparities and validity equal;
   the mean fill of the masked pixels allclose at rtol 1e-6: its sum runs
   in another order on the card), SGM and MGM at 128^2 with 2 levels and
   subpixel none, SGM also masked (equal), ``calc_disparity_sgm``
   at 128^2 with the 64x8 search, SGM and MGM (validity equal, parabola
   allclose at atol 2e-5), config 4 at 256^2 with 2 levels (integer disparities and
   validity equal, parabola allclose at atol 1e-4), ``calc_disparity`` with
   ncc and ternary census 7x7 at 128^2 (equal).
5. Time the frames and each kernel with CUDA events (the scans on the
   register-carry, the path-line and the cluster kernel in turns with
   ``line_scan_kernel<0>`` / ``<1>`` at the same shapes, with us per step,
   the path-line kernel at each number of lines a block and the
   register-carry kernel over a cluster at each number of lanes a block;
   each abs, NCC and
   census sweep shape on its band kernel in turns with ``sweep_kernel<cost,
   words>``, between events and as device time; each speckle case, also as
   device time; the winner-take-all step at each of ``WTA_CASES``, against
   its plain version and its byte bound), and profile one frame of each path, ``calc_disparity_sgm``'s
   too, for the device's idle share and its device time by kernel name (the
   three sweep kernels apart), ``calc_disparity_sgm(use_mgm=True)``'s and
   the 1024^2 MGM frame's too; the CLI frame and its parabola variant
   (median of 10 frames after 2 warm-ups, Mp/s, device time, idle share,
   launches, the sweep launches by level), the LoG prefilter's device time
   and launches over the frame's 12 pyramid levels, and the blob filter's
   passes and time on the frame's level-0 validity (card against CPU) and
   on a serpentine 1024^2 blob; config7-em-1024 and its affine variant
   (frame, device time, idle share, launches, peak memory, and the
   refiner alone: its ms, device time, launches and share) and
   cli-em-1024 (the CLI's wall time with its TIFF IO, device time,
   launches); config5-mosaic-1024 (the plan's host ms, the first frame on
   fresh plans apart, then the frame: median of 10 after 2 warm-ups,
   canvas Mp/s, device time, idle share, launches, peak memory);
   config1-1024 and config2-1024 (median of 10 frames after 2 warm-ups,
   Mp/s, device time by kernel, idle share, launches, peak memory, host
   time by operator) and cli-match-1024 (each tool's wall time with its
   TIFF IO, median of 3 chains; the chain's device time, launches and host
   time by operator); config8-1024 (median of 10 frames after 2 warm-ups,
   Mp/s, device time by kernel, idle share, launches, peak memory, host
   time by operator).
6. Run ``parallel/`` on ``torch.distributed`` in a world of one rank
   (``"cpu:gloo,cuda:nccl"``, a ``file://`` rendezvous in a temporary
   directory, destroyed at the end), each run with the launch counts set to
   0 just before it and read just after: ``hierarchical_sharded_correlate``
   at the bench settings with the parabola (``bench.py``'s sanity check;
   >= 0.99 of the 16-px core agreeing with the monolithic engine on the
   card; ``band_sweep_kernel`` and speckle launched); the same call at
   512^2 with a left mask, the L<->R check, the blob filter and the LoG
   prefilter (card = CPU); hierarchical SGM and MGM at config 6 (card =
   CPU within 2e-5; the scans launched); ``sharded_pyramid_correlate`` on
   the bench pair (sanity); ``disparity_sharded_search`` at 1024^2 with the
   64x8 volume and the 15x15 kernel (equal to ``best_of_search_
   convolution`` on the card; ``band_sweep_kernel`` launched); and
   ``reproject_mosaic(mesh=...)`` on config 5 (equal to ``mesh=None``).
   Each frame timed (median of 5 after 2 warm-ups, Mp/s, device time, idle
   share, launches by kernel, peak memory, beside the card's name and power
   limit). With two cards or more, a world of up to four NCCL ranks (this
   script with ``--parallel-rank``, one a card) runs the hierarchical bench
   frame, held to the sanity check and the 0.99 agreement; with one card
   the script says that it did not run.
7. Host IO and tile pyramids (``phase_host_io``; no kernel of ``csrc/``
   is on this path): build the native runtime with g++ (its seconds
   printed); host-io-8192: an 8192^2 float32 texture made on the card from
   a seed, written by ``block_write_image`` on the native route (tile 256,
   1024 tiles, 4 threads) and read back bit for bit; the card tile function
   alone (every tile on one thread; device time a tile); the same write
   with card work in ``tile_fn`` (each tile read with a 2-px margin from
   a ``DiskImageView``, blurred with the pyramid kernel on the card with a
   zero edge, cropped), the file within 1e-6 of the card's whole-frame
   blur; again with a georef and a nodata value (the Python route), the
   georef and nodata read back; two writes whose ``tile_fn`` raises
   part-way (the error must reach the caller; ``resume_completed_tiles``
   names exactly the tiles on disk); each write's wall and MiB/s, the peak
   device memory. pyramid-8192: ``DiskImagePyramid`` (8 levels, 8192 ->
   64) on the card against the same on the CPU (each level within 1e-6),
   ``get_image_clip`` at scales 1, 0.5, 0.25 and 1/128 (levels and
   shapes), the build's wall and device time. image2qtree-config5:
   config 5's four sources as GeoTIFFs through ``tools/image2qtree.main``
   with ``--blend multiband`` and ``draft`` at tile 256: at 1024 card
   against CPU (the same tiles and KML, tiles within 1 LSB on >= 0.999 of
   the pixels), at 2048 (four 1228^2 sources) on the card, timed. The
   launch counts, set to 0 before the pyramid and image2qtree runs and read
   after, must all be 0. Its numbers go under ``host_io_*`` keys of the
   summary line.
8. Cameras, triangulation and DEMs (``phase_stereo_dem``), stereo-dem-1024:
   the Ames Stereo Pipeline flow of a nadir frame-camera pair on WGS84 at
   (-122, 37): two TSAI pinholes (f 1500 px, principal point 511.5, k1
   -0.1, k2 0.02, p1 1e-3, p2 -5e-4) 1000 m above the datum, 30 m apart
   east-west (the left one east; centres on the fp32 grid), small attitude
   errors; a true DEM of smooth hills (0-100 m, seed 23) and the bench
   texture at 2048^2 on geographic georefs over an 800 m square. Each
   1024^2 image is rendered through the port (``pixel_to_vector``'s TSAI
   Newton, ``camera_pixel_to_dem_xyz`` on the true DEM, lon/lat, a bilinear
   texture sample). The chain, each step's ``csrc/`` launches counted:
   ``epipolar_rectify``, ``camera_transform`` of both images into the
   rectified cameras with their coverage as masks, ``pyramid_correlate`` at
   the bench settings with those masks (``band_sweep_kernel`` 5 and speckle
   9 launches; no other step launches any), ``StereoModel.point_cloud``,
   ``point_image_to_dem`` onto the 512^2 grid, ``hillshade`` and
   ``colormap`` shaded by it. Gates: >= 0.9 of the 16-px core whose true
   right pixel lies inside within 0.5 px of the true disparity (float64,
   from each pixel's DEM hit); the points from the true disparity within
   0.6 m of the float64 oracle on every pixel, for the chain's pair and for
   the same pair at float64 centres; >= 0.9 of the DEM's cells within
   Z^2 / (f b) * 0.5 px + 1 m of the true DEM; the CAHV route
   (``pinhole_to_cahv``) within 1 m of the pinhole route; round trips at
   every pixel of 1024^2 (the TSAI pinhole, CAHVOR, CAHVORE at linearities
   1, 0.5 and 0) within ``DEM_RT``; card against CPU, each step from the
   same inputs, all equal: the warps and their masks, the points, errors and
   validity, the DEM and its cells, hillshade and colormap, the
   ``undistort_image``, ``hillshade`` and ``colormap --hillshade`` tools'
   files; ``orthoproject`` of the left image onto the recovered DEM held
   piece by piece (the ground points' lon/lat/height equal, their ECEF
   points within ``DEM_ECEF_ULPS`` fp32 ulps, the CPU's ``point_to_pixel``
   and ``sample`` of the card's points equal the card's, the card's
   orthoimage equal to its pieces). The scene and its
   float64 oracle are in ``stereo_dem_scene.py``. Timing: each step's ms
   (median of 5 chains after 2 warm-ups, CUDA events between the steps),
   device ms, device launches and idle share (torch.profiler), the chain's
   Mp/s, peak device memory, the phase's wall. Its numbers go under ``stereo_dem_*``
   keys of the summary line.
9. The rest of the camera layer (``phase_cameras_ii``) over stereo-dem's
   place, true DEM and texture. opticalbar-dem-1024: two ``OpticalBarModel``
   s (KH-4/KH-9 style panoramic cameras: 1024^2, pitch 7.8e-4 m, f 1 m, a
   0.8 rad scan in 0.5 s) 1000 m up, flying north at 60 m/s, 30 m apart
   east-west (centres on the fp32 grid), each image rendered through the
   port (``pixel_to_vector``, the per-pixel ``camera_center``,
   ``camera_pixel_to_dem_xyz``, the texture); the chain, unrectified:
   ``pyramid_correlate`` (15x15, 4 levels, tile 64, parabola, search
   ``sds.OB_SEARCH``, masks of where each ray hits the DEM),
   ``StereoModel.point_cloud`` (float64 per-pixel centres),
   ``point_image_to_dem`` onto 512^2, ``hillshade``; beside it
   ``OpticalBarModel.point_to_pixel`` and ``solve_point_to_pixel`` of every
   rendered ground point (one call each) and ``fit_pinhole`` on the card
   (stereo-dem's left pinhole from a seed 5 m and 5 mrad off, 24 ground
   points). bathy-dem-1024: stereo-dem's pinhole pair and chain over a water
   plane 30 m above the datum (index 1.34), rendered through refracted rays
   (the float64 surface point and bent ray of each pixel whose terrain lies
   under the plane); its triangulate step runs ``StereoModel`` on every
   pixel and ``BathyStereoModel`` where that point lies below the plane,
   merged; then the DEM and hillshade; beside it the DEM of ``StereoModel``
   alone. bayer-1024: ``bayer_demosaic`` of a 1024^2 mosaic of three bench
   textures in the four patterns. Gates: each correlator >= 0.9 of the
   16-px core within 0.5 px of the float64 true disparity (the optical
   bar's by a float64 fixed-point projection, the water's by a float64
   Snell solve); points from the true disparity within 0.6 m of their
   float64 oracles (opticalbar; bathy under the water through
   ``BathyStereoModel``, on land through ``StereoModel``); the DEMs on >=
   0.9 of their cells within Z^2 / (f b) * 0.5 px + 1 m (bathy's under the
   water and on land apart); the round trips within 1 px; ``fit_pinhole``'s
   reprojection within ``FIT_PX`` and card = CPU; the refraction-free
   depths shallower (median ratio <= ``BATHY_SHALLOW``); card against CPU:
   equal (bathy's triangulation, DEM and hillshade, opticalbar's DEM and
   hillshade from the card's inputs, Bayer's four patterns) but the
   optical-bar rays and their triangulation (``OB_RAY_UNITS``,
   ``OB_POINT_ULPS``, ``OB_ERR_M``); 5 ``band_sweep_kernel`` and 9 speckle
   launches in each correlator step and no ``csrc/`` launch elsewhere.
   Timing as phase 8's (each step's ms, device ms, launches and idle share,
   each chain's Mp/s, peak memory), the solves' and the fit's walls, device
   ms and launches, Bayer's ms; the numbers go under ``opticalbar_dem_*``,
   ``bathy_dem_*``, ``fit_pinhole_*`` and ``bayer_*`` keys.
10. The flood suite (``phase_flood``; no kernel of ``csrc/`` is on this
   path, and none may launch), on scenes ``flood_scene.py`` makes on the card
   from seeds and writes as the files a user hands the tools (nothing is
   downloaded). flood-s1-8192: a Sentinel-1 IW GRD scene (8192^2 uint16 DN
   at 10 m in UTM 15N, the affine turned 12 degrees as a descending pass;
   land -8 dB, water -20 dB sigma0 with 4-look gamma speckle; a meandering
   river 30-150 px wide plus lakes, 15 % of the frame; 0-DN wedges along two
   edges) through ``sentinel1_flood_detect``'s steps (``clean_sentinel1_
   borders``, the bicubic north-up warp onto 9717^2, ``detect_water --mode
   sentinel1``, tile 512), then the tool with a 30 m DEM on another grid
   (``reproject_image`` resamples it; clean and warp reused). landsat8-4096
   (B2-B7, B10 and an MTL text; land, water and 5 % cloud), worldview-4096
   (8 bands and an IMD text), spot-4096 (4 bands): ``detect_water``;
   modis-4800 (bands 1-2 at 4800^2, 3-7 at 2400^2): ``extract_modis``
   (upsampling on the card), then ``detect_water --mode modis`` (evi). Gates
   (each raises): of the pixels farther than 3 px from a shore, >= 0.95 of
   the water ones classed water and <= 0.02 of the land ones (clouds
   anywhere) classed water. Card against CPU at 1024^2 (the scenes made on
   the CPU, the same files to both): the S1 chain without and with the DEM
   (class maps equal on >= 0.999: the warp's fp32 lon/lat differ by an ulp
   or two, held apart at <= 4 ulps of longitude), Martinis on one warped
   frame and the four optical chains (>= 0.9999), the Martinis thresholds
   within a histogram bin (400/255); ``build_control_network`` on
   stereo-dem's rectified pair and a third camera (4096 ground points): the
   network card = CPU, >= 0.99 of the points kept, each within 0.6 m of
   float64. Timing: each step once under the profiler for S1 (its wall,
   device ms, launches, idle share, peak memory; the labelling passes), the
   optical steps timed then profiled; each chain's Mp/s; the Martinis
   threshold and tiles kept; the numbers go under ``flood_*`` and
   ``cnet_*`` keys.

Prints the times on earlier lines, then one JSON line of per-kernel
numbers, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without a CUDA device or without the
``visionworkbench_torch`` package beside it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

import flood_scene as fs
import stereo_dem_scene as sds
from stereo_dem_scene import texture as _texture

# Main-path configuration (bench.py:30-33).
H = W = 1024
SEARCH = (0, -4, 64, 8)      # x_min, y_min, width, height
KERNEL = (15, 15)
LEVELS = 4
TILE = 64

# The correlate CLI's defaults (visionworkbench_tpu/tools/correlate.py:20-60)
# on the bench pair and search box: 21x21 kernel, the LoG prefilter of
# width 1.4, 5 pyramid levels (levels 5-0 run), tile 64, speckle
# half-kernel 5, subpixel none; the blob filter's area where it is on.
CLI_KERNEL = (21, 21)
CLI_LEVELS = 5
CLI = dict(kernel_size=CLI_KERNEL, max_pyramid_levels=CLI_LEVELS, tile_size=TILE,
           prefilter_mode="log", prefilter_width=1.4, filter_half_kernel=5)
CLI_BLOB_AREA = 64
# The CLI frame's level-0 sweeps: without the ring (subpixel none) and with
# it (subpixel parabola).
CLI_LEVEL0 = (("level0", 0, False), ("level0_patches", 1, False))

# SGM configuration (tools_bench_configs.py:232-254, config 6): census 5x5
# (the SGM default census window), default penalties P1 15 / P2 750.
SGM_HW = 512
SGM_SEARCH = (0, -1, 64, 2)
SGM_P1, SGM_P2 = 15.0, 750.0
SGM_BAD = 255.0 + SGM_P2
# calc_disparity_sgm as docs/stereo.md calls it: a 64x8 search volume.
CALC_HW = 256
CALC_SEARCH = (64, 8)
# The winner-take-all step's main-path volumes (H, W, sy, sx): asp-mgm's
# level 0 (a 1536^2 tile, 3 x 5 cells: the register variant's 16-cell
# instance), config 6's level 0 (2 x 5) and a coarse level (1 x 5), and
# calc_disparity_sgm's 64x8 search (512 cells: the wide variant).
WTA_CASES = (("mgm_level0_1536", (1536, 1536, 3, 5)), ("level0", (SGM_HW, SGM_HW, 2, 5)),
             ("level1", (SGM_HW // 2, SGM_HW // 2, 1, 5)),
             ("calc_64x8", (CALC_HW, CALC_HW, CALC_SEARCH[1], CALC_SEARCH[0])))

# Config 4 (tools_bench_configs.py:166-182): the bench frame with census
# 5x5 costs. Config 3 and its census/NCC variants (tools_bench_configs.py:
# 150-164, tools_ab_sweep.py:96-110): calc_disparity over the 1024^2 frame,
# 32x1 search, 15x15 kernel, the right frame edge-padded by 31 columns.
CENSUS_WINDOW = 5
CALC3_SEARCH = (32, 1)
CALC3_OUT = H - KERNEL[1] + 1
# Kernel 7's run on config 3's frames: per-tile offsets (12, 0), an 11x1
# window (disparities 12..22 around the true 16).
K7_WINDOW = (11, 1)
K7_OFFSET = (12, 0)

# Config 7 (tools_bench_configs.py:256-275): the pyramid correlator with
# census 5x5 costs, a 7x7 kernel, 4 levels (levels 4-0), tile 64 and the
# Bayes-EM refiner (subpixel "em"; also run with "affine") on config 7's
# 1024^2 texture (seed 11) in bench.py's orientation: left(p) == right(p +
# (16, 0)). (tools_bench_configs.py:96-104 slices the pair the other way
# round, d = -16, outside the search box.)
CONFIG7 = dict(kernel_size=(7, 7), cost_type="census", census_window=5,
               max_pyramid_levels=4, tile_size=TILE)
CONFIG7_SEED = 11
# The correlate CLI's arguments for cli-em-1024: its defaults (21x21, LoG
# 1.4, 5 levels, tile 64) with the Bayes-EM refiner, on the bench search
# box as cli-log-1024.
CLI_EM_ARGS = ["--subpixel", "em", "--yoffset", str(SEARCH[1])]
# Config 5 (tools_bench_configs.py:184-230): four sources of 0.6 n square
# (614^2 at n = 1024) cut from the texture of seed 11, each at its own
# diagonal georef, reprojected into an n^2 canvas at scale 0.01 and
# multiband-blended over 4 levels; plans made once, as the config makes them.
C5_LEVELS = 4
C5_SPECS = ((0.0102, -0.05, 1.05), (0.0098, 0.45, 1.04), (0.0101, -0.04, 0.56),
            (0.0099, 0.46, 0.55))    # (scale, x0 / (n 0.01), y0 / (n 0.01))
# Config 1 (tools_bench_configs.py:113-126): a Gaussian blur of sigma 1.5,
# then 4 blur-downsamples (a 5-level pyramid), on the texture of seed 11.
C1_SIGMA = 1.5
C1_LEVELS = 4
# Config 2 (tools_bench_configs.py:128-148): on both images of the pair
# tex[:, :n], tex[:, 16:16 + n] (seed 11), upright single-scale Harris (512
# points, threshold 1e-8), upright sgrad descriptors, matching at ratio 0.8.
C2_POINTS = 512
C2_THRESHOLD = 1e-8
C2_RATIO = 0.8
# Config 8 (tools_bench_configs.py:277-295): detect_sift_like (the DoG
# detector at 512 points: 1008 slots, orientations and oriented
# descriptors) on both images of config 2's pair, matching at ratio 0.8.
C8_POINTS = 512
C8_RATIO = 0.8
# ipfind's SIFT-class operators on cli-match's TIFFs, each followed by
# ipmatch right left: (name, ipfind arguments, ipmatch arguments, gated).
# The default operator (sift) at ipmatch's default ratio 0.6 finds too few
# matches to pre-align this pair (5 at 512^2 in both packages, fewer than
# RANSAC's 4 at 1024^2): it runs for its counts, and gated at config 8's
# ratio 0.8.
C8_CHAINS = (("sift", [], [], False),
             ("sift_r08", [], ["--matcher-threshold", "0.8"], True),
             ("obalog", ["--interest-operator", "obalog"], [], True))
# cli-match-1024: the bench pair's right image rotated by 1 degree about
# its centre; ipfind, ipmatch (similarity RANSAC) and correlate
# --match-file. The pre-alignment (visionworkbench_tpu/tools/correlate.py:
# 94-106, followed exactly) warps by the inverse of the homography fitted
# from the file's second list to its first, which aligns the right image
# when the file lists the right image's points first: ipmatch runs on
# (right, left). (With (left, right) it applies the map twice: a 2-degree
# residual, on which the coarse levels lock onto the bench texture's
# half-period alias; the smoke runs that chain too and requires it to fail
# the gate.) The search box holds the residual in its interior. The
# pre-alignment's map stays within MATCH_PREALIGN_BOUND px of the true one
# (the bench shift, then the rotation) over the frame on ipmatch's file,
# within MATCH_EXACT_BOUND px on the exact file.
MATCH_ROTATION_DEG = 1.0
MATCH_IPFIND = ["--interest-operator", "harris", "--single-scale"]
MATCH_SEARCH = (-8, -8, 16, 16)
MATCH_CORRELATE = ["--xoffset", str(MATCH_SEARCH[0]), "--yoffset", str(MATCH_SEARCH[1]),
                   "--xrange", str(MATCH_SEARCH[2]), "--yrange", str(MATCH_SEARCH[3])]
MATCH_PREALIGN_BOUND = 0.3
MATCH_EXACT_BOUND = 0.05

# Published H100 SXM peaks (NVIDIA's data sheet): HBM rate and fp32
# rate outside the tensor cores. int32 ALU work is counted at the fp32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Least operations per pixel and candidate of a sweep with sliding window
# sums: cost (2), column running sum (2), row running sum (2); plus the
# best/worst update (2) for each searched (not ring) candidate.
SWEEP_OPS_BOX = 6
SWEEP_OPS_SELECT = 2
# Census: an xor and a popcount per code word and the adds joining the
# words, then the two running sums (4); computing the codes once per frame
# pixel: a compare and an or per sample position (two of each, ternary).
CENSUS_CODE_OPS = 2
# NCC per pixel and candidate: the product, the two running sums (4),
# lprec * rprec, the square root and the scale (3); each window energy
# (left per pixel, right per window position): square, the two running
# sums, the reciprocal.
SWEEP_OPS_NCC = 8
NCC_ENERGY_OPS = 6
# Per pixel and window neighbour of the speckle stencil: two field
# extracts, two differences, two abs, two compares, an and, an add.
SPECKLE_OPS = 10
# Per disparity cell, lane, step and path direction of an SGM scan: the
# separable 3x3 grid min (4), + P1, two mins, - min_prior, + cost (5), the
# absent-candidate compare and select (2), the min_prior reduction (1) and
# the sum into the output (1). An MGM step evaluates two path updates
# (2 x 10), averages them (add, multiply, floor), applies the guard (1) and
# forces absent candidates (2).
SCAN_OPS = 13
MGM_OPS = 26


def _make_pair(h, w, seed=7):
    """bench.py's pair: left(p) == right(p + (16, 0)) (config 7's texture
    with ``seed`` 11)."""
    tex = _texture(h, w, seed)
    return tex[:, 16:16 + w], tex[:, :w]


def sweep_ops_census(n_words):
    return 3 * n_words - 1 + 4


def _make_calc_pair(h, w):
    """The same texture for ``calc_disparity_sgm``: the right frame carries
    the search margin, and left(p) == right(p + (16, 3))."""
    sx, sy = CALC_SEARCH
    _, right = _make_pair(h + sy - 1, w + sx - 1)
    return right[3:3 + h, 16:16 + w].copy(), right


def _quantized(rng, shape):
    return (rng.integers(0, 256, shape) / 256.0).astype(np.float32)


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---- phase 1 ----------------------------------------------------------------

def _ptxas_table(text):
    """{kernel function: {"regs", "spill", "stack"}} from an -Xptxas=-v log
    (spill: bytes of spill stores and loads)."""
    table, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
        if m:
            fn = table.setdefault(m.group(1), {"regs": 0, "spill": 0, "stack": 0})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn is not None:
            fn.update(stack=int(m[1]), spill=int(m[2]) + int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["regs"] = int(m[1])
    return table


# csrc/mgm_scan.cu's modes, as its template argument numbers them
MGM_MODES = ("fwd", "bidir", "sgm")


def _mgm_instances(table):
    """{(sy, sx, mode): ptxas entry} of csrc/mgm_scan.cu's
    mgm_scan_kernel<SY, SX, MODE, CLUSTER>; mode "fwd", "bidir" or "sgm",
    and "fwd_cluster" or "bidir_cluster" for the cluster instances."""
    out = {}
    for name, v in table.items():
        m = re.search(r"mgm_scan_kernelILi(\d+)ELi(\d+)ELi([012])ELb([01])E", name)
        if m:
            mode = MGM_MODES[int(m[3])] + ("_cluster" if m[4] == "1" else "")
            out[(int(m[1]), int(m[2]), mode)] = v
    return out


def _band_instances(table):
    """{(cost, K): ptxas entry} of csrc/sweep.cu's band kernels:
    band_sweep_kernel<cost, K> (abs, sq, ncc) and band_census_kernel<
    n_words, K> (census1, census2)."""
    out = {}
    for name, v in table.items():
        m = re.search(r"band_sweep_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            out[(("abs", "sq", "ncc")[int(m[1])], int(m[2]))] = v
        m = re.search(r"band_census_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            out[(f"census{m[1]}", int(m[2]))] = v
    return out


def _cluster_instances(table):
    """{(T, K, mode): ptxas entry} of csrc/mgm_cluster_scan.cu's
    cluster_wide_kernel<T, K, MODE>."""
    out = {}
    for name, v in table.items():
        m = re.search(r"cluster_wide_kernelILi(\d+)ELi(\d+)ELi([01])E", name)
        if m:
            out[(int(m[1]), int(m[2]), MGM_MODES[int(m[3])])] = v
    return out


def _path_instances(table):
    """{K: ptxas entry} of csrc/sgm_path_scan.cu's path_scan_kernel<K>."""
    out = {}
    for name, v in table.items():
        m = re.search(r"path_scan_kernelILi(\d+)E", name)
        if m:
            out[int(m[1])] = v
    return out


def phase_build():
    from visionworkbench_torch.ops import _build, sgm_scan
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        table = _ptxas_table(log.read_text() if log.exists() else "")
        if name == "mgm_cluster_scan":
            inst = _cluster_instances(table)
            max_k = _build.CLUSTER_MAX_CELLS // 32
            want = {(t, k, m) for m in ("fwd", "bidir")
                    for t, k in [(16, 1 << i) for i in range(1, max_k.bit_length())]
                    + [(32, max_k)]}
            bad = [key for key, v in inst.items() if v["spill"] or v["stack"]]
            print(f"[build] mgm_cluster_scan: {len(inst)} instances; instances that "
                  f"spill: {bad or 'none'}")
            for key in sorted(inst):
                print(f"[build] mgm_cluster_scan (T, K, mode) {key}: {inst[key]['regs']} "
                      f"registers, {inst[key]['spill']} B spilled, {inst[key]['stack']} B stack")
            if set(inst) != want or bad:
                raise SystemExit(f"mgm_cluster_scan: instances missing {sorted(want - set(inst))}"
                                 f", unexpected {sorted(set(inst) - want)}, spilling: {bad}")
            continue
        if name == "sgm_path_scan":
            inst = _path_instances(table)
            want = {1 << i for i in range(_build.PATH_SCAN_MAX_CELLS.bit_length() - 5)}
            bad = [k for k, v in inst.items() if v["spill"] or v["stack"]]
            for k in sorted(inst):
                print(f"[build] sgm_path_scan: path_scan_kernel<{k}>: {inst[k]['regs']} "
                      f"registers, {inst[k]['spill']} B spilled, {inst[k]['stack']} B stack")
            if set(inst) != want or bad:
                raise SystemExit(f"sgm_path_scan: instances {sorted(inst)} (want "
                                 f"{sorted(want)}), spilling: {bad}")
            continue
        if name != "mgm_scan":
            for fn, v in table.items():
                print(f"[build] {name}: {fn[:70]}: {v['regs']} registers, "
                      f"{v['spill']} B spilled, {v['stack']} B stack")
            if name == "sweep":
                band = _band_instances(table)
                bad = [key for key, v in band.items() if v["spill"] or v["stack"]]
                want = {(c, k) for c in ("abs", "sq", "ncc", "census1", "census2")
                        for k in _build.SWEEP_BAND_K}
                print(f"[build] sweep: band kernels (cost or census words, K): "
                      f"{ {key: band[key]['regs'] for key in sorted(band)} } registers; "
                      f"instances that spill: {bad or 'none'}")
                if set(band) != want or bad:
                    raise SystemExit(f"sweep: band kernel instances {sorted(band)} "
                                     f"(want {sorted(want)}), spilling: {bad}")
            if name == "sgm_wta":
                inst = {("wide" if "sgm_wta_wide_kernel" in fn else int(m[1])): v
                        for fn, v in table.items()
                        if "sgm_wta_wide_kernel" in fn
                        or (m := re.search(r"sgm_wta_kernelILi(\d+)E", fn))}
                bad = [k for k, v in inst.items() if v["spill"]]
                if set(inst) != {4, 8, 16, 32, "wide"} or bad:
                    raise SystemExit(f"sgm_wta: instances {list(inst)}, spilling: {bad}")
            if name == "speckle":
                rows = {int(m[1]): v for fn, v in table.items()
                        if (m := re.search(r"speckle_kernelILi(\d+)E", fn))}
                bad = [r for r, v in rows.items() if v["spill"] or v["stack"]]
                if set(rows) != {1, 3, 5, 7, 9, 11} or bad:
                    raise SystemExit(f"speckle: instances (rows a pass) {sorted(rows)}, "
                                     f"spilling: {bad}")
            continue
        inst = _mgm_instances(table)
        if not inst:
            raise SystemExit("mgm_scan: no kernel instance in the build log")
        # every instance is one the wrappers select (ops/sgm_scan.py:
        # _mgm_variant, _cluster_variant), at up to _build.MGM_MAX_LANES
        # threads (a block a line, or a block of a cluster): every grid of
        # up to _build.MGM_MAX_CELLS cells in each mode, and in the MGM modes
        # over a cluster
        cells = _build.MGM_MAX_CELLS
        want = {(y, x, m) for y in range(1, cells + 1) for x in range(1, cells // y + 1)
                for m in (*MGM_MODES, "fwd_cluster", "bidir_cluster")}
        bad = [(key, v) for key, v in sorted(inst.items())
               if sgm_scan._mgm_variant(key[0], key[1], _build.MGM_MAX_LANES) is None
               or v["spill"] or v["stack"]]
        if set(inst) != want:
            bad.append(("instances missing", sorted(want - set(inst))))
            bad.append(("unexpected instances", sorted(set(inst) - want)))
        regs = [v["regs"] for v in inst.values()]
        print(f"[build] mgm_scan: {len(inst)} instances, {min(regs)}-{max(regs)} "
              f"registers, instances that spill or are past the limits: {bad or 'none'}")
        for grid in ((2, 5), (1, 5), (1, 4), (4, 4)):
            for mode in (*MGM_MODES, "fwd_cluster", "bidir_cluster"):
                print(f"[build] mgm_scan (sy, sx, mode) {(*grid, mode)}: "
                      f"{inst.get((*grid, mode))}")
        if bad:
            raise SystemExit(f"mgm_scan: instances spill or are past the limits: {bad}")


# ---- phase 2 ----------------------------------------------------------------

def sweep_cases(kernel=KERNEL, levels=LEVELS,
                level0=(("level0_patches", 1, False), ("level0_rl", 0, True)), search=SEARCH):
    """The sweep's shapes on the main path, one per launch of the bench
    frame: levels 4 to 1, level 0 with the patch ring, and the level-0 R->L
    pass (the L<->R check); or, given the CLI's kernel, levels and
    ``CLI_LEVEL0``, those of the CLI frame (with ``MATCH_SEARCH``, those of
    cli-match's correlation)."""
    kw, kh = kernel
    cases = []
    for name, level, ring, rl in ([(f"level{lv}", lv, 0, False) for lv in range(levels, 0, -1)]
                                  + [(n, 0, r, rl) for n, r, rl in level0]):
        s = 1 << level
        s_w, s_h = max(search[2] // s, 1), max(search[3] // s, 1)
        sx, sy = min(11, s_w), min(11, s_h)
        out = -(-H // s)
        if rl:
            out = min(out + search[2], H + search[3])
        nt = -(-out // TILE)
        lb = nt * TILE + kw - 1
        if rl:      # left frame with the (S-1 + max_off) margin
            mh = lb + (sy - 1) + (sy - 1 + s_h - sy)
            mw = lb + (sx - 1) + (sx - 1 + s_w - sx)
        else:
            mh = lb + s_h - 1 + 2 * ring
            mw = lb + s_w - 1 + 2 * ring
        if level == levels:    # the coarsest level searches its whole range
            sx, sy = s_w, s_h
        cases.append(dict(name=name, nt=nt, lb=lb, mh=mh, mw=mw, sx=sx, sy=sy,
                          max_off=(s_w - sx, s_h - sy), ring=ring, kernel=kernel))
    return cases


def _sweep_inputs(case, dev, seed, texture=False):
    """Quantized frames, the left one embedded in the right so the search
    has true winners; with ``texture``, the bench pair's texture instead
    (off the 1/256 grid, where the summation order shows). Random per-tile
    offsets in the level's range."""
    import torch
    rng = np.random.default_rng(seed)
    lb, mh, mw = case["lb"], case["mh"], case["mw"]
    if texture:
        left, right = _make_pair(max(lb, mh), max(lb, mw))
        base, match = left[:lb, :lb].copy(), right[:mh, :mw].copy()
    else:
        base = _quantized(rng, (lb, lb))
        match = _quantized(rng, (mh, mw))
        match[2:2 + lb, 3:3 + lb] = base[:mh - 2, :mw - 3]
    nt = case["nt"]
    offs = np.stack([rng.integers(0, case["max_off"][0] + 1, (nt, nt)),
                     rng.integers(0, case["max_off"][1] + 1, (nt, nt))], -1)
    return (torch.as_tensor(base, device=dev), torch.as_tensor(match, device=dev),
            torch.as_tensor(offs.astype(np.int32), device=dev))


def sweep_mode_cases():
    """Each sweep mode and the main-path shapes it runs at: (row key,
    shape name, cost, census window). The sq cost (band_sweep_kernel's
    other instance) runs at level 0 with the ring; NCC (no patch mode) at
    every level without it, level 0 and the tile of 128 with black blocks
    (zero-energy windows)."""
    rows = []
    for c in sweep_cases():
        rows.append(("sweep", c, "abs", 5))
        rows.append(("sweep_census", c, "census", CENSUS_WINDOW))
        if c["name"] == "level0_patches":
            rows.append(("sweep_sq", c, "sq", 5))
            rows.append(("sweep_ternary_census", c, "ternary_census", 7))
            rows.append(("sweep_ncc", {**c, "name": "level0", "ring": 0, "mh": c["mh"] - 2,
                                       "mw": c["mw"] - 2, "black": True}, "ncc", 5))
        else:
            rows.append(("sweep_ncc", c, "ncc", 5))
    # pyramid_correlate(tile_size=128) at level 1's shape: NCC on
    # band_sweep_kernel, census on band_census_kernel (sweep_kernel, held
    # against both, runs its pixels in rounds there)
    level1 = next(c for c in sweep_cases() if c["name"] == "level1")
    nt = -(-(H >> 1) // 128)
    lb = nt * 128 + KERNEL[0] - 1
    t128 = {**level1, "name": "level1_tile128", "tile": 128, "nt": nt, "lb": lb,
            "mh": lb + level1["mh"] - level1["lb"], "mw": lb + level1["mw"] - level1["lb"]}
    rows.append(("sweep_ncc", {**t128, "black": True}, "ncc", 5))
    rows.append(("sweep_census", t128, "census", CENSUS_WINDOW))
    # the CLI frame's abs sweeps (21x21: band_sweep_kernel<abs, 24>), and
    # those of cli-match's correlation (its 16x16 search box: windows 2x2 to
    # 11x11 over levels 3-0, no ring)
    for c in sweep_cases(CLI_KERNEL, CLI_LEVELS, CLI_LEVEL0):
        rows.append(("sweep_cli", {**c, "name": "cli_" + c["name"]}, "abs", 5))
    for c in sweep_cases(CLI_KERNEL, _match_levels(), (("level0", 0, False),), MATCH_SEARCH):
        rows.append(("sweep_cli", {**c, "name": "match_" + c["name"]}, "abs", 5))
    return rows


def _band(case, cost, cw=5):
    """K of the band kernel instance the wrapper picks for a sweep case
    (band_sweep_kernel for abs/sq/ncc, band_census_kernel for census), or
    None where sweep_kernel runs it."""
    from visionworkbench_torch.ops import sweep
    kw, kh = case.get("kernel", KERNEL)
    return sweep._sweep_variant(cost, case.get("tile", TILE), case["sx"], case["sy"],
                                kw, kh, case["ring"], cw)


def _old_kernel_name(cost, cw):
    """The sweep_kernel instance that computes a cost."""
    from visionworkbench_torch.image.census import census_words
    if cost in ("census", "ternary_census"):
        return f"sweep_kernel<3,{census_words(cw, cost == 'ternary_census')}>"
    return f"sweep_kernel<{('abs', 'sq', 'ncc').index(cost)},1>"


def _band_counts():
    """(band_sweep_kernel, band_census_kernel) launches so far."""
    from visionworkbench_torch.ops import sweep
    return sweep.band_launches, sweep.census_band_launches


def _band_name(cost):
    return "band_census_kernel" if cost in ("census", "ternary_census") else "band_sweep_kernel"


def _calc3_pair(h=None, w=None):
    """Config 3's frames (H x W unless given): the bench pair, the right
    frame edge-padded by 31 columns (tools_bench_configs.py:155)."""
    left, right = _make_pair(h or H, w or W)
    return left, np.pad(right, ((0, 0), (0, CALC3_SEARCH[0] - 1)), mode="edge")


def _frame_inputs(dev, seed):
    """Quantized frames at config 3's shape, left(p) == right(p + (16, 0)),
    with black blocks in both frames: zero-energy NCC windows give NaN
    metrics (the JAX package's first-NaN-wins rule)."""
    import torch
    rng = np.random.default_rng(seed)
    right = _quantized(rng, (H, W + CALC3_SEARCH[0] - 1))
    left = right[:, 16:16 + W].copy()
    y0, y1, x0 = H * 3 // 10, H * 4 // 10, W // 2
    left[y0:y1, x0:x0 + W // 8] = 0.0
    right[y0:y1, x0:x0 + W // 8 + 40] = 0.0
    right[H * 6 // 10:H * 7 // 10, W // 10:W // 5] = 0.0
    return torch.as_tensor(left, device=dev), torch.as_tensor(right, device=dev)


def _k7_args(left, right, dev, seed=None):
    """Kernel 7's inputs on config 3's frames: tile grid of TILE covering
    the 1010^2 output, per-tile offsets (K7_OFFSET, or random in range)."""
    import torch
    from visionworkbench_torch.image.edge import crop_extended
    kw, kh = KERNEL
    nt = -(-CALC3_OUT // TILE)
    side = nt * TILE + kw - 1
    base = crop_extended(left, 0, 0, side, side)
    match = crop_extended(right, 0, 0, side + CALC3_SEARCH[0] - 1, side)
    if seed is None:
        offs = torch.tensor(K7_OFFSET, dtype=torch.int32, device=dev).expand(nt, nt, 2)
    else:
        rng = np.random.default_rng(seed)
        offs = torch.as_tensor(rng.integers(0, CALC3_SEARCH[0] - K7_WINDOW[0] + 1,
                                            (nt, nt, 2)).astype(np.int32), device=dev)
        offs[..., 1] = 0
    return base, match, offs.contiguous(), TILE, *K7_WINDOW, kw, kh, "abs"


def _max_err(got, ref):
    """Largest difference between two output tuples (None entries skipped;
    NaN equal to NaN; bool planes count mismatches)."""
    import torch
    e = 0.0
    for a, b in zip(got, ref):
        if b is None:
            continue
        if a.dtype == torch.bool:
            e = max(e, float((a != b).sum()))
            continue
        d = (a.double() - b.double()).abs()
        if a.is_floating_point():
            d = torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d)
        e = max(e, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return e


def speckle_cases():
    """The speckle stencil's shapes on the main path (level 0 11x11, a
    coarse level's 3x3 second pass), one odd frame, a window with hh != hv
    (the kernel's rows in passes) and a frame smaller than a block."""
    return [dict(name="1024x1024_11x11", h=1024, w=1024, hh=5, hv=5, t=3, min_match=61),
            dict(name="512x512_3x3", h=512, w=512, hh=1, hv=1, t=3, min_match=2),
            dict(name="1000x777_11x11", h=1000, w=777, hh=5, hv=5, t=3, min_match=61),
            dict(name="517x301_5x15", h=517, w=301, hh=2, hv=7, t=2, min_match=40),
            dict(name="5x3_11x11", h=5, w=3, hh=5, hv=5, t=3, min_match=61)]


def _speckle_input(case, dev, seed):
    import torch
    from visionworkbench_torch.stereo.disparity import _pack_code
    rng = np.random.default_rng(seed)
    h, w = case["h"], case["w"]
    dx = 16 + rng.integers(-2, 3, (h, w))
    dx = np.where(rng.random((h, w)) < 0.15, rng.integers(0, 64, (h, w)), dx)
    dy = rng.integers(-1, 2, (h, w))
    disp = torch.as_tensor(np.stack([dx, dy], -1).astype(np.int32), device=dev)
    valid = torch.as_tensor(rng.random((h, w)) < 0.9, device=dev)
    return _pack_code(disp, valid)


def _wta_volume(shape, dev, seed, ties):
    """An (H, W, sy, sx) accumulated volume on ``dev`` of integer costs:
    three levels 40 apart where ``ties`` (most pixels' minima repeat, some
    through all six cascade iterations), else 100-8999 (mostly unique);
    absent candidates (8 * SGM_BAD) at 8 % of the cells and along the
    first column and the last row of a tenth of the pixels' grids, one
    pixel all absent."""
    import torch
    from visionworkbench_torch.ops import sgm_wta
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = shape[:2]
    lo, hi, step = (0, 3, 40.0) if ties else (100, 9000, 1.0)
    vol = 300.0 * ties + step * torch.randint(lo, hi, shape, generator=g, device=dev,
                                              dtype=torch.float32)
    absent = sgm_wta.N_PATHS * SGM_BAD
    vol[torch.rand(shape, generator=g, device=dev) < 0.08] = absent
    edge = torch.rand((h, w), generator=g, device=dev) < 0.1
    vol[edge, :, 0] = absent
    vol[edge, -1, :] = absent
    vol[0, 0] = absent
    return vol


def _wta_check(acc, mode, bad, what, err):
    """The wrapper (one launch) against the plain version on the card: the
    float32 words of winners and both offsets equal."""
    import torch
    from visionworkbench_torch.ops import sgm_wta
    before = sgm_wta.launches
    got = sgm_wta.volume_argmin_subpixel(acc, mode, bad)
    ran = sgm_wta.launches - before
    ref = sgm_wta.volume_argmin_subpixel_plain(acc, mode, bad)
    torch.cuda.synchronize()
    words = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    e = float((got.double() - ref.double()).abs().max())
    err["sgm_wta"] = max(err["sgm_wta"], e)
    if ran != 1 or words:
        raise SystemExit(f"sgm_wta {what}: {ran} launches, {words} float32 words differ "
                         f"from the plain version (max_abs_err {e})")
    return got


def scan_cases():
    """The SGM/MGM scans' shapes on config 6's main path: the level-0
    (512^2, window 5x2) x-scan (3 directions), y-scan and MGM scans, the
    level-4 x- and y-scans (64^2 padded, window 4x1), and the SGM and MGM
    scans of levels 4-1 (window 4x1, then 5x1 over 64-256 lanes); and
    ``calc_disparity_sgm``'s x- and y-scans at the 64x8 search on 256^2
    (512 cells: the path-line kernel), an odd 3x11 grid with N > L on the
    path-line kernel; and the MGM scans that run the cluster kernel: those
    of ``calc_disparity_sgm(use_mgm=True)`` at the 64x8 search on 256^2,
    of config 6's level 0 at 1024^2 (1024 lanes) and of the one-level
    pyramid with config 6's 64x2 search on 64x512 (128 cells)."""
    n = SGM_HW
    levels = []
    for lv in (1, 2, 3):
        nl = n >> lv
        levels += [dict(kernel="scan_bidir", name=f"level{lv}_x", shape=(nl, 1, 5, nl),
                        shifts=(0, 1, -1)),
                   dict(kernel="scan_bidir", name=f"level{lv}_y", shape=(nl, 1, 5, nl),
                        shifts=(0,)),
                   dict(kernel="mgm_fwd", name=f"level{lv}_sheared",
                        shape=(2 * nl, 4, 1, 5, nl), shifts=(0, 1)),
                   dict(kernel="mgm_bidir", name=f"level{lv}", shape=(nl, 1, 5, nl),
                        shifts=(1, -1))]
    return [dict(kernel="scan_bidir", name="level0_x", shape=(n, 2, 5, n), shifts=(0, 1, -1)),
            dict(kernel="scan_bidir", name="level0_y", shape=(n, 2, 5, n), shifts=(0,)),
            dict(kernel="scan_bidir", name="level4_x", shape=(64, 1, 4, 64), shifts=(0, 1, -1)),
            dict(kernel="scan_bidir", name="level4_y", shape=(64, 1, 4, 64), shifts=(0,)),
            dict(kernel="mgm_fwd", name="level0_sheared", shape=(2 * n, 4, 2, 5, n),
                 shifts=(0, 1)),
            dict(kernel="mgm_bidir", name="level0", shape=(n, 2, 5, n), shifts=(1, -1)),
            dict(kernel="mgm_fwd", name="level4_sheared", shape=(128, 4, 1, 4, 64),
                 shifts=(0, 1)),
            dict(kernel="mgm_bidir", name="level4", shape=(64, 1, 4, 64), shifts=(1, -1)),
            *levels,
            dict(kernel="scan_bidir", name="calc_x",
                 shape=(CALC_HW, CALC_SEARCH[1], CALC_SEARCH[0], CALC_HW),
                 shifts=(0, 1, -1)),
            dict(kernel="scan_bidir", name="calc_y",
                 shape=(CALC_HW, CALC_SEARCH[1], CALC_SEARCH[0], CALC_HW), shifts=(0,)),
            dict(kernel="scan_bidir", name="odd_3x11", shape=(300, 3, 11, 200),
                 shifts=(0, 1, -1)),
            *mgm_cluster_cases()]


def mgm_cluster_cases():
    """The MGM scans that run a cluster a line: ``calc_disparity_sgm(
    use_mgm=True)`` at the 64x8 search on 256^2 and the one-level 64x2
    search on 64x512 (csrc/mgm_cluster_scan.cu), config 6's level 0 at
    1024^2 (csrc/mgm_scan.cu's kernel over a cluster)."""
    sx, sy = CALC_SEARCH
    return [dict(kernel="mgm_bidir", name="calc", shape=(CALC_HW, sy, sx, CALC_HW),
                 shifts=(1, -1)),
            dict(kernel="mgm_fwd", name="calc_sheared",
                 shape=(2 * CALC_HW, 4, sy, sx, CALC_HW), shifts=(0, 1)),
            dict(kernel="mgm_bidir", name="level0_1024", shape=(H, 2, 5, W), shifts=(1, -1)),
            dict(kernel="mgm_fwd", name="level0_sheared_1024", shape=(2 * H, 4, 2, 5, W),
                 shifts=(0, 1)),
            dict(kernel="mgm_bidir", name="single_rows", shape=(64, 2, 64, 512),
                 shifts=(1, -1)),
            dict(kernel="mgm_bidir", name="single_cols", shape=(512, 2, 64, 64),
                 shifts=(1, -1)),
            dict(kernel="mgm_fwd", name="single_sheared", shape=(576, 4, 2, 64, 64),
                 shifts=(0, 1))]


def _scan_inputs(case, dev, seed):
    """Integer-valued inputs: census 5x5 costs (<= 24) with 3 % absent
    candidates, pixel differences in [0, 256) (those of 8-bit images, so
    the P2' clamp is reached), guards."""
    import torch
    rng = np.random.default_rng(seed)
    shape = case["shape"]
    cost = np.floor(rng.random(shape) * 25).astype(np.float32)
    cost[rng.random(shape) < 0.03] = SGM_BAD
    n, nl = shape[0], shape[-1]
    side = {"scan_bidir": (n, len(case["shifts"]), nl), "mgm_bidir": (n, nl),
            "mgm_fwd": (n, shape[1], nl)}[case["kernel"]]

    def pd():
        return np.floor(rng.random(side) * 256).astype(np.float32)

    def guard():
        return rng.random(side) > 0.1

    arrays = {"scan_bidir": (cost, pd(), pd()),
              "mgm_bidir": (cost, pd(), pd(), guard(), guard()),
              "mgm_fwd": (cost, pd(), guard())}[case["kernel"]]
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _scan_call(case, inputs, plain=False):
    from visionworkbench_torch.ops import sgm_scan
    fn = getattr(sgm_scan, case["kernel"] + ("_plain" if plain else ""))
    return fn(*inputs, case["shifts"], SGM_P1, SGM_P2, SGM_BAD)


def _scan_pick(case):
    """The kernel the wrapper picks for a scan case: ("mgm_scan", threads),
    ("path_scan", (cells a thread, lines a block)), ("cluster_scan", its
    launch) or (line_scan_kernel<.>, None)."""
    import torch
    from visionworkbench_torch.ops import sgm_scan
    sy, sx, nl = case["shape"][-3:]
    if case["kernel"] == "scan_bidir":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        threads, other = sgm_scan._scan_bidir_pick(case["shape"][0], sy, sx, nl,
                                                   case["shifts"], sms)
        name = "path_scan"
    else:
        threads, other = sgm_scan._mgm_pick(sy, sx, nl)
        name = "cluster_scan"
    if threads is not None:
        return "mgm_scan", threads
    return (name, other) if other is not None else (_old_kernel(case), None)


def _scan_ran(case, call):
    """Run ``call`` and return the kernel it launched, by the counts:
    "mgm_scan", "path_scan", "cluster_scan" or line_scan_kernel<.>."""
    from visionworkbench_torch.ops import sgm_scan
    k = case["kernel"]
    counts = (sgm_scan.mgm_scan_launches, sgm_scan.path_scan_launches,
              sgm_scan.cluster_scan_launches)
    before = [c.get(k, 0) for c in counts]
    out = call()
    ran = [c.get(k, 0) - b for c, b in zip(counts, before)]
    names = ("mgm_scan", "path_scan", "cluster_scan")
    return out, next((n for n, r in zip(names, ran) if r), _old_kernel(case))


def _cluster_row(variant):
    """The kernels row suffix of a cluster-a-line launch: "lane_cluster"
    (the register-carry kernel of csrc/mgm_scan.cu over a cluster, a thread
    a lane) or "cluster" (csrc/mgm_cluster_scan.cu)."""
    return "lane_cluster" if variant[0] == 1 else "cluster"


def _old_kernel(case):
    """The csrc/sgm_scan.cu kernel that computes the case's function."""
    return f"line_scan_kernel<{int(case['kernel'] != 'scan_bidir')}>"


def _line_scan_call(case, inputs):
    """A scan case on line_scan_kernel<0> (scan_bidir) or <1> (MGM) of
    csrc/sgm_scan.cu, whatever the wrapper would pick."""
    from visionworkbench_torch.ops import sgm_scan
    fn = getattr(sgm_scan, f"_{case['kernel']}_cuda")
    return fn(*inputs, case["shifts"], SGM_P1, SGM_P2, SGM_BAD, None)


def _scan_work(case):
    """(bytes, operations) of one scan: each input read once, the output
    written once; operations per cell, lane, step and path direction."""
    shape, k = case["shape"], case["kernel"]
    n, nl, cells = shape[0], shape[-1], shape[-3] * shape[-2]
    if k == "scan_bidir":
        b = len(case["shifts"])
        return 4 * (2 * n * cells * nl + 2 * n * b * nl), SCAN_OPS * 2 * b * n * cells * nl
    if k == "mgm_bidir":
        return 4 * (2 * n * cells * nl + 2 * n * nl) + 2 * n * nl, MGM_OPS * 2 * n * cells * nl
    b = shape[1]
    return (4 * (2 * n * b * cells * nl + n * b * nl) + n * b * nl,
            MGM_OPS * n * b * cells * nl)


def phase_kernels(dev):
    import torch
    from visionworkbench_torch.ops import speckle, sweep
    kw, kh = KERNEL
    from visionworkbench_torch.ops import cost_volume
    err = {k: 0.0 for k in ("sweep", "sweep_cli", "sweep_census", "sweep_ternary_census",
                            "sweep_ncc", "sweep_census_codes", "best_of_search",
                            "tiled_search", "speckle", "scan_bidir",
                            "scan_bidir_path_scan", "mgm_bidir", "mgm_fwd",
                            "mgm_bidir_cluster", "mgm_fwd_cluster",
                            "mgm_bidir_lane_cluster", "mgm_fwd_lane_cluster", "sgm_wta")}

    def check(key, what, got, ref):
        torch.cuda.synchronize()
        e = _max_err(got, ref)
        err[key] = max(err[key], e)
        print(f"[kernels] {key} {what}: valid {float(got[1].float().mean()):.4f}, "
              f"max_abs_err {e}")
        if e != 0.0:
            raise SystemExit(f"{key} disagrees with its plain version at {what}")

    def held(row, what, args, k, n):
        """One sweep through the wrapper (the counts show which kernel ran),
        held against the plain version and, on a band kernel, against
        sweep_kernel on the same inputs."""
        cost, cw = args[8], args[10]
        best = [torch.empty(n, n, device=dev) for _ in range(3)]
        before = _band_counts()
        got = (*sweep.sweep(*args, best_out=best[0]), best[0])
        ran = tuple(a - b for a, b in zip(_band_counts(), before))
        want = (0, 0) if k is None else (0, 1) if cost in ("census", "ternary_census") else (1, 0)
        name = f"{_band_name(cost)} K {k}" if k is not None else _old_kernel_name(cost, cw)
        if ran != want:
            raise SystemExit(f"sweep {what}: band launches {ran}, expected {want} ({name})")
        what = f"{what}, {name})"
        check(row, what, got, (*sweep.sweep_plain(*args, best_out=best[1]), best[1]))
        if k is not None:
            old = (*sweep._sweep_cuda(*args, best[2], None), best[2])
            check(row, f"{what} vs {_old_kernel_name(cost, cw)}", got, old)
        return got

    for i, (key, c, cost, cw) in enumerate(sweep_mode_cases()):
        k = _band(c, cost, cw)
        tile = c.get("tile", TILE)
        for texture in ((False, True) if k is not None else (False,)):
            base, match, offs = _sweep_inputs(c, dev, 100 + i, texture)
            if c.get("black"):     # zero-energy NCC windows
                base[40:90, 100:180] = 0.0
                match[50:110, 90:200] = 0.0
            args = (base, match, offs, tile, c["sx"], c["sy"], *c["kernel"], cost,
                    bool(c["ring"]), cw)
            # sq is band_sweep_kernel's other instance: its row is abs's
            row = "sweep" if key == "sweep_sq" else key
            held(row, f"{c['name']} ({cost} {cw}, {'texture' if texture else 'quantized'}, "
                 f"kernel {c['kernel']}, tiles {c['nt']}x{c['nt']} of {tile}, "
                 f"window {c['sx']}x{c['sy']}", args, k, c["nt"] * tile)
    left, right = _frame_inputs(dev, 150)
    sx, sy = CALC3_SEARCH
    for key, cost, cw in (("sweep_ncc", "ncc", 5), ("sweep_census_codes", "census", 7)):
        args = (left, right, sx, sy, kw, kh, cost, cw)
        got = sweep.search_frame(*args, want_best=True)
        ref = sweep.search_frame(*args, want_best=True, plain=True)
        if cost == "ncc":
            nan = got[2].isnan()
            print(f"[kernels] sweep_ncc: {int(nan.sum())} pixels with a NaN metric, "
                  f"all valid: {bool(got[1][nan].all())}")
            if not (bool(nan.any()) and bool(got[1][nan].all())):
                raise SystemExit("sweep_ncc: the zero-energy windows did not give "
                                 "valid NaN-metric pixels")
        check(key, f"config3 ({cost} {cw}, {H}x{W}, window {sx}x{sy})", got, ref)
        # the frame's sweep itself (census: on code planes), on both kernels
        base, match, offs, t = sweep.frame_sweep_args(left, right, sx, sy, kw, kh, cost, cw)
        fargs = (base, match, offs, t, sx, sy, kw, kh, cost, False, cw)
        k = sweep._sweep_variant(cost, t, sx, sy, kw, kh, 0, cw, True)
        held(key, f"config3 frame sweep ({cost} {cw}, tiles of {t}", fargs, k,
             offs.shape[0] * t)
    args = (left, right, sx, sy, kw, kh, "abs")
    check("best_of_search", "config3 (abs)", cost_volume.best_of_search(*args),
          cost_volume.best_of_search_plain(*args))
    args = _k7_args(left, right, dev, seed=160)
    got = cost_volume.tiled_search(*args)
    zeroed = bool((got[0][~got[1]] == 0).all())
    check("tiled_search", f"config3 tiles (abs, window {K7_WINDOW}, invalid "
          f"disparities zeroed: {zeroed})", got, cost_volume.tiled_search_plain(*args))
    if not zeroed:
        raise SystemExit("tiled_search: invalid disparities are not zeroed")
    for i, c in enumerate(speckle_cases()):
        code = _speckle_input(c, dev, 200 + i)
        args = (code, c["hh"], c["hv"], c["t"], c["min_match"])
        k1 = speckle.speckle_keep_mask(*args)
        k0 = speckle.speckle_keep_mask_plain(*args)
        torch.cuda.synchronize()
        e = float((k1 != k0).sum())
        err["speckle"] = max(err["speckle"], e)
        print(f"[kernels] speckle {c['name']}: keep {float(k1.float().mean()):.4f}, "
              f"max_abs_err {e}")
        if e != 0.0:
            raise SystemExit(f"speckle kernel disagrees with its plain version at {c['name']}")
    for i, c in enumerate(scan_cases()):
        inputs = _scan_inputs(c, dev, 300 + i)
        got, which = _scan_ran(c, lambda: _scan_call(c, inputs))
        ref = _scan_call(c, inputs, plain=True)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        # scan_bidir's rows: the register-carry kernel and the path-line one;
        # the MGM scans': the register-carry kernel a block a line and a
        # cluster a line, and the cluster kernel
        want, variant = _scan_pick(c)
        key = ("scan_bidir_path_scan" if which == "path_scan" else
               f"{c['kernel']}_{_cluster_row(variant)}" if which == "cluster_scan"
               else c["kernel"])
        err[key] = max(err[key], e)
        if which != want:
            raise SystemExit(f"{c['kernel']} {c['name']}: ran {which}, expected {want}")
        print(f"[kernels] {c['kernel']} {c['name']} {c['shape']} shifts {c['shifts']} "
              f"{which} {variant}: mean {float(got.mean()):.4f}, max_abs_err {e}")
        if e != 0.0:
            raise SystemExit(f"{c['kernel']} kernel disagrees with its plain version "
                             f"at {c['name']}")
        if which in ("mgm_scan", "path_scan", "cluster_scan"):
            old = _line_scan_call(c, inputs)
            torch.cuda.synchronize()
            e = float((got - old).abs().max())
            print(f"[kernels] {c['kernel']} {c['name']}: {which} vs {_old_kernel(c)} "
                  f"max_abs_err {e}")
            if e != 0.0:
                raise SystemExit(f"{c['kernel']} {c['name']}: {which} disagrees with "
                                 f"{_old_kernel(c)}")
    _wta_kernels(dev, err)
    return err


def _wta_kernels(dev, err):
    """sgm_wta's kernel against its plain version, bit for bit: every mode
    at each of ``WTA_CASES`` on tie-rich and on distinct costs; then every
    volume that config 6's MGM frame and ``calc_disparity_sgm(use_mgm=True)``
    hand the step (the wrapper called through a spy)."""
    import torch
    from visionworkbench_torch.ops import sgm_wta
    from visionworkbench_torch.stereo import sgm
    for i, (name, shape) in enumerate(WTA_CASES):
        for ties in (True, False):
            acc = _wta_volume(shape, dev, 600 + 2 * i + ties, ties)
            for mode in sgm_wta._MODES:
                got = _wta_check(acc, mode, SGM_BAD, f"{name} {shape} {mode}", err)
            print(f"[kernels] sgm_wta {name} {shape} ({'tie-rich' if ties else 'distinct'} "
                  f"costs): every mode equal to the plain version; lc_blend dx mean "
                  f"{float(got[..., 0].mean()):.4f}")
            del acc
    seen = []

    def spy(acc, subpixel, bad):
        out = _wta_check(acc, subpixel, bad, f"main path {tuple(acc.shape)}", err)
        seen.append(tuple(acc.shape))
        return out
    real = sgm.volume_argmin_subpixel
    sgm.volume_argmin_subpixel = spy
    try:
        _sgm_run(*_make_pair(SGM_HW, SGM_HW), dev, "mgm")
        _calc_run(*_make_calc_pair(CALC_HW, CALC_HW), dev, use_mgm=True)
    finally:
        sgm.volume_argmin_subpixel = real
    print(f"[kernels] sgm_wta main-path volumes (MGM frame, calc_disparity_sgm MGM), "
          f"each equal to the plain version: {seen}")
    if len(seen) != LEVELS + 2 or seen[-1][2:] != (CALC_SEARCH[1], CALC_SEARCH[0]):
        raise SystemExit(f"sgm_wta: the spy saw {seen}")


# ---- phase 3 ----------------------------------------------------------------

def _bench_run(left, right, dev, **kw):
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    return pyramid_correlate(left, right, BBox2i(*SEARCH), kernel_size=KERNEL,
                             max_pyramid_levels=LEVELS, tile_size=TILE,
                             subpixel="parabola", device=dev, **kw)


def _sanity(dm, what, h=H, w=W):
    """bench.py:104-110, plus shape and finiteness."""
    import torch
    if tuple(dm.disparity.shape) != (h, w, 2) or tuple(dm.valid.shape) != (h, w):
        raise SystemExit(f"{what}: wrong output shape {tuple(dm.disparity.shape)}")
    if not bool(torch.isfinite(dm.disparity).all()):
        raise SystemExit(f"{what}: non-finite disparities")
    d, v = dm.to_numpy()
    core = np.s_[32:-32, 32:-32]
    vc = v[core]
    frac = (np.abs(d[..., 0][core] - 16.0) < 0.5)[vc].mean() if vc.any() else 0.0
    print(f"[main] {what}: core valid {vc.mean():.4f}, within 0.5 px of 16: {frac:.4f}")
    if vc.mean() < 0.5 or frac < 0.9:
        raise SystemExit(f"{what}: sanity failed (valid {vc.mean():.3f}, correct {frac:.3f})")


def _cli_run(left, right, dev, **kw):
    """``pyramid_correlate`` with the correlate CLI's defaults on the bench
    pair and search box (``CLI``); ``kw`` adds or overrides options."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    return pyramid_correlate(left, right, BBox2i(*SEARCH), device=dev, **{**CLI, **kw})


def _cli_levels(corr_timeout=0.0, spo=None):
    """The CLI frame's searches, coarsest first: ``(level, s_w_l, s_h_l,
    s_x_eff, s_y_eff)``, as ``pyramid_correlate`` plans them (within a
    ``corr_timeout`` budget at ``spo`` s/op when one is given)."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import (
        level_searches, max_pyramid_levels_for)
    levels = max_pyramid_levels_for(W, H, CLI_KERNEL, BBox2i(*SEARCH), CLI_LEVELS)
    return level_searches(H, W, levels, SEARCH[2:], 11, None, corr_timeout, spo)


def _level_pixels(level):
    return -(-H // (1 << level)) * -(-W // (1 << level))


def _cli_level_kernels(ring0=0, plan=None):
    """The sweep kernel each level of the CLI frame runs (the wrapper's
    pick at each level's shape)."""
    from visionworkbench_torch.ops import sweep
    out = []
    for level, _, _, sx, sy in plan or _cli_levels():
        ring = ring0 if level == 0 else 0
        k = sweep._sweep_variant("abs", TILE, sx, sy, *CLI_KERNEL, ring)
        out.append((level, sx, sy, "sweep_kernel<0,1>" if k is None
                    else f"band_sweep_kernel<abs, {k}>"))
    return out


def _cli_budget(spo):
    """A ``corr_timeout`` that leaves levels 5-1 whole and degrades level
    0: their predicted times plus 40 s/op-pixels of level 0, so level 0's
    (64, 8) search halves to (4, 8) (volume 32 <= 40 < 64)."""
    from visionworkbench_torch.stereo import cost_model
    spent = sum(cost_model.estimate_search_time(_level_pixels(lv), (sx, sy), spo)
                for lv, _, _, sx, sy in _cli_levels() if lv > 0)
    return spent + 40 * _level_pixels(0) * spo


def _sgm_run(left, right, dev, algo):
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    return pyramid_correlate(left, right, BBox2i(*SGM_SEARCH), kernel_size=(5, 5),
                             max_pyramid_levels=LEVELS, tile_size=TILE,
                             stereo_algorithm=algo, subpixel="parabola", device=dev)


def _calc_run(left, right, dev, use_mgm=False):
    from visionworkbench_torch.stereo.sgm import calc_disparity_sgm
    return calc_disparity_sgm(left, right, CALC_SEARCH, kernel_size=5,
                              cost_type="census", use_mgm=use_mgm,
                              subpixel="parabola", device=dev)


def _calc3_run(left, right, dev, cost, cw=5):
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.correlation import calc_disparity
    return calc_disparity(cost, left, right, BBox2i(0, 0, W, H), CALC3_SEARCH,
                          KERNEL, census_window=cw, device=dev)


def _k6_run(left, right, dev):
    """Kernel 6's entry point on config 3's frames (abs)."""
    from visionworkbench_torch.ops.cost_volume import best_of_search
    from visionworkbench_torch.stereo.correlation import DisparityMap
    d, v, _ = best_of_search(left, right, *CALC3_SEARCH, *KERNEL, "abs")
    return DisparityMap(d, v)


def _k7_run(left, right, dev):
    """Kernel 7's entry point on config 3's frames: tile offsets (12, 0)."""
    from visionworkbench_torch.ops.cost_volume import tiled_search
    from visionworkbench_torch.stereo.correlation import DisparityMap
    d, v = tiled_search(*_k7_args(left, right, dev))
    return DisparityMap(d[:CALC3_OUT, :CALC3_OUT], v[:CALC3_OUT, :CALC3_OUT])


def _config7_run(left, right, dev, subpixel="em"):
    """Config 7's frame (``CONFIG7``) with ``subpixel``."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    return pyramid_correlate(left, right, BBox2i(*SEARCH), subpixel=subpixel,
                             device=dev, **CONFIG7)


def _config7_refiner(dm, left, right, subpixel):
    """The refiner of config 7's frame alone, on the frame's integer map,
    as ``pyramid_correlate`` calls it."""
    from visionworkbench_torch.stereo.subpixel_refine import bayes_em_subpixel
    return bayes_em_subpixel(dm, left, right, CONFIG7["kernel_size"],
                             em_iters=2 if subpixel == "em" else 0,
                             max_pyramid_levels=0, outer_iters=3)


def _write_pair(left, right, folder):
    """The pair as float32 TIFFs in ``folder``: (left path, right path)."""
    import os
    from visionworkbench_torch.fileio import write_tiff
    paths = [os.path.join(folder, f"{name}.tif") for name in ("left", "right")]
    for path, img in zip(paths, (left, right)):
        write_tiff(path, np.asarray(img, np.float32))
    return paths


def _cli_em_run(paths, dev, folder):
    """cli-em-1024: the port's correlate CLI on the pair's TIFFs
    (``CLI_EM_ARGS``), the output TIFF read back: (DisparityMap, the CLI's
    wall seconds, IO included)."""
    import os
    import torch
    from visionworkbench_torch.fileio import read_tiff
    from visionworkbench_torch.stereo.correlation import DisparityMap
    from visionworkbench_torch.tools import correlate
    prefix = os.path.join(folder, "disparity")
    t0 = time.perf_counter()
    if correlate.main([*paths, "-o", prefix, *CLI_EM_ARGS], device=dev) != 0:
        raise SystemExit("cli_em: the correlate CLI failed")
    wall = time.perf_counter() - t0
    out, info = read_tiff(prefix + ".tif")
    if out.shape != (H, W, 3) or not info.tiled:
        raise SystemExit(f"cli_em: output TIFF {out.shape}, tiled {info.tiled}")
    return DisparityMap(torch.as_tensor(out[..., :2]), torch.as_tensor(out[..., 2] > 0.5)), wall


def _reset_counts():
    from visionworkbench_torch.ops import sgm_scan, sgm_wta, speckle, sweep
    sweep.launches = 0
    sgm_wta.launches = 0
    sweep.band_launches = 0
    sweep.census_band_launches = 0
    speckle.launches = 0
    for counts in (sgm_scan.launches, sgm_scan.mgm_scan_launches,
                   sgm_scan.path_scan_launches, sgm_scan.cluster_scan_launches):
        for k in counts:
            counts[k] = 0


def _read_counts():
    """Launches per wrapper; ``<wrapper>/mgm_scan``,
    ``scan_bidir/path_scan`` and ``<wrapper>/cluster_scan``: of those, the
    launches of the register-carry kernel, of the path-line kernel and of
    the cluster kernel; ``sweep/band`` and
    ``sweep/census_band``: the sweep's launches of band_sweep_kernel and of
    band_census_kernel; ``sgm_wta``: the winner-take-all step's."""
    from visionworkbench_torch.ops import sgm_scan, sgm_wta, speckle, sweep
    return {"sweep": sweep.launches, "sweep/band": sweep.band_launches,
            "sweep/census_band": sweep.census_band_launches,
            "speckle": speckle.launches, "sgm_wta": sgm_wta.launches, **sgm_scan.launches,
            **{f"{k}/mgm_scan": v for k, v in sgm_scan.mgm_scan_launches.items()},
            **{f"{k}/path_scan": v for k, v in sgm_scan.path_scan_launches.items()},
            **{f"{k}/cluster_scan": v for k, v in sgm_scan.cluster_scan_launches.items()}}


def _cli_runs(left, right, dev):
    """The CLI frame's main-path runs, as phase 3 drives them: ``(name, run,
    expected launches, side)``. Measures the port's s/op on ``dev`` first
    (its launches come before any run's counts are set to 0)."""
    import torch
    from visionworkbench_torch.stereo import cost_model
    # the CLI frame: levels 5-0, each one abs sweep on band_sweep_kernel
    # (K 24) and the speckle passes (two at levels 5-1, one at level 0)
    cli = {"sweep": 6, "sweep/band": 6, "speckle": 11}
    cli_out = {}
    spo = cost_model.calc_seconds_per_op(device=dev)
    budget = _cli_budget(spo)
    plan = _cli_levels(budget, spo)
    print(f"[main] cli_log_timeout: the port's s/op on the card {spo!r}; "
          f"corr_timeout {budget!r} s; searches (level, size, window): "
          + ", ".join(f"{lv}: {sw}x{sh} -> {sx}x{sy}" for lv, sw, sh, sx, sy in plan))
    if plan[-1][3:] != (4, 8) or [p[3:] for p in plan[:-1]] != [
            p[3:] for p in _cli_levels()[:-1]]:
        raise SystemExit(f"cli_log_timeout: the budget should degrade level 0 "
                         f"alone, to 4x8: {plan}")

    def cli_plain():
        cli_out["plain"] = _cli_run(left, right, dev)
        return cli_out["plain"]

    def cli_keep_levels():
        res = _cli_run(left, right, dev, keep_levels=True)
        shapes = [tuple(m.disparity.shape) for m in res.level_disparities]
        want = [(-(-H // (1 << lv)), -(-W // (1 << lv)), 2) for lv in range(CLI_LEVELS, -1, -1)]
        finite = all(bool(torch.isfinite(m.disparity.float()).all())
                     for m in res.level_disparities)
        same = (torch.equal(res.disparity.disparity, cli_out["plain"].disparity)
                and torch.equal(res.disparity.valid, cli_out["plain"].valid))
        print(f"[main] cli_log_keep_levels: {len(shapes)} level maps {shapes}, finite "
              f"{finite}, final map equal to cli_log's: {same}")
        if shapes != want or not finite or not same:
            raise SystemExit(f"cli_log_keep_levels: level maps {shapes} (want {want}), "
                             f"finite {finite}, final equal {same}")
        return res.disparity

    def cli_blob():
        dm = _cli_run(left, right, dev, blob_filter_area=CLI_BLOB_AREA)
        v0, v1 = cli_out["plain"].valid, dm.valid
        print(f"[main] cli_log_blob: valid {int(v1.sum())} of {v1.numel()} (without the "
              f"filter {int(v0.sum())}; {int((v0 & ~v1).sum())} dropped, "
              f"{int((v1 & ~v0).sum())} gained through the coarse levels' offsets)")
        return dm

    return [
        ("cli_log", cli_plain, cli, H),
        ("cli_log_parabola", lambda: _cli_run(left, right, dev, subpixel="parabola"), cli, H),
        ("cli_log_keep_levels", cli_keep_levels, cli, H),
        ("cli_log_blob", cli_blob, cli, H),
        ("cli_log_timeout", lambda: _cli_run(left, right, dev, corr_timeout=budget,
                                             seconds_per_op=spo), cli, H)], plan


def phase_main(dev):
    import torch
    left, right = _make_pair(H, W)
    sgm_left, sgm_right = _make_pair(SGM_HW, SGM_HW)
    calc_left, calc_right = _make_calc_pair(CALC_HW, CALC_HW)
    c3_left, c3_right = (torch.as_tensor(a, device=dev) for a in _calc3_pair())
    none = {"sweep": 0, "sweep/band": 0, "sweep/census_band": 0, "scan_bidir": 0,
            "mgm_bidir": 0, "mgm_fwd": 0, "scan_bidir/mgm_scan": 0, "mgm_bidir/mgm_scan": 0,
            "mgm_fwd/mgm_scan": 0, "scan_bidir/path_scan": 0, "mgm_bidir/cluster_scan": 0,
            "mgm_fwd/cluster_scan": 0, "sgm_wta": 0}
    # abs and NCC sweeps all on band_sweep_kernel, census on
    # band_census_kernel
    c3 = {"sweep": 1, "speckle": 0}
    c3_abs = {**c3, "sweep/band": 1}
    c3_census = {**c3, "sweep/census_band": 1}
    cli_runs, plan = _cli_runs(left, right, dev)
    c7_left, c7_right = (torch.as_tensor(a, device=dev)
                         for a in _make_pair(H, W, CONFIG7_SEED))
    folder = tempfile.mkdtemp(prefix="chip_smoke_cli_em_")
    paths = _write_pair(left, right, folder)

    def cli_em():
        dm, wall = _cli_em_run(paths, dev, folder)
        print(f"[main] cli_em: the CLI's wall time (TIFF IO included) {wall:.4f} s")
        return dm
    runs = (("plain", lambda: _bench_run(left, right, dev), {"sweep": 5, "sweep/band": 5}, H),
            ("consistency", lambda: _bench_run(left, right, dev, consistency_threshold=2.0),
             {"sweep": 6, "sweep/band": 6}, H),
            ("sgm", lambda: _sgm_run(sgm_left, sgm_right, dev, "sgm"),
             {"scan_bidir": 10, "scan_bidir/mgm_scan": 10, "sgm_wta": 5}, SGM_HW),
            ("mgm", lambda: _sgm_run(sgm_left, sgm_right, dev, "mgm"),
             {"mgm_fwd": 5, "mgm_bidir": 10, "mgm_fwd/mgm_scan": 5,
              "mgm_bidir/mgm_scan": 10, "sgm_wta": 5}, SGM_HW),
            # 512 cells a lane: both scans on the path-line kernel, none on
            # line_scan_kernel<0>
            ("calc_sgm", lambda: _calc_run(calc_left, calc_right, dev),
             {"scan_bidir": 2, "scan_bidir/path_scan": 2, "speckle": 0, "sgm_wta": 1},
             CALC_HW),
            # 512 cells a lane: the three MGM scans on the cluster kernel
            ("calc_mgm", lambda: _calc_run(calc_left, calc_right, dev, use_mgm=True),
             {"mgm_bidir": 2, "mgm_fwd": 1, "mgm_bidir/cluster_scan": 2,
              "mgm_fwd/cluster_scan": 1, "speckle": 0, "sgm_wta": 1}, CALC_HW),
            # config 6's MGM pyramid at 1024^2: level 0 (1024 lanes) on the
            # cluster kernel, levels 1-4 on the register-carry kernel
            ("mgm_1024", lambda: _sgm_run(left, right, dev, "mgm"),
             {"mgm_fwd": 5, "mgm_bidir": 10, "mgm_fwd/mgm_scan": 4, "mgm_bidir/mgm_scan": 8,
              "mgm_fwd/cluster_scan": 1, "mgm_bidir/cluster_scan": 2, "sgm_wta": 5}, H),
            ("config4", lambda: _bench_run(left, right, dev, cost_type="census",
                                           census_window=CENSUS_WINDOW),
             {"sweep": 5, "sweep/census_band": 5}, H),
            ("config4_lr", lambda: _bench_run(left, right, dev, cost_type="census",
                                              census_window=CENSUS_WINDOW,
                                              consistency_threshold=2.0),
             {"sweep": 6, "sweep/census_band": 6}, H),
            ("config4_ternary7", lambda: _bench_run(left, right, dev,
                                                    cost_type="ternary_census",
                                                    census_window=7),
             {"sweep": 5, "sweep/census_band": 5}, H),
            ("ncc", lambda: _bench_run(left, right, dev, cost_type="ncc"),
             {"sweep": 5, "sweep/band": 5}, H),
            ("ncc_lr", lambda: _bench_run(left, right, dev, cost_type="ncc",
                                          consistency_threshold=2.0),
             {"sweep": 6, "sweep/band": 6}, H),
            ("calc3_abs", lambda: _calc3_run(c3_left, c3_right, dev, "abs"), c3_abs,
             CALC3_OUT),
            ("calc3_ncc", lambda: _calc3_run(c3_left, c3_right, dev, "ncc"), c3_abs,
             CALC3_OUT),
            ("calc3_census7", lambda: _calc3_run(c3_left, c3_right, dev, "census", 7),
             c3_census, CALC3_OUT),
            ("k6_best_of_search", lambda: _k6_run(c3_left, c3_right, dev), c3_abs, CALC3_OUT),
            ("k7_tiled_search", lambda: _k7_run(c3_left, c3_right, dev), c3_abs, CALC3_OUT),
            # the correlate CLI's defaults (cli-log-1024), its parabola and
            # the options at full width
            *cli_runs,
            # config 7: the census sweep at levels 4-0 on band_census_kernel,
            # then the Bayes-EM / affine refiner (plain tensor work)
            ("config7_em", lambda: _config7_run(c7_left, c7_right, dev, "em"),
             {"sweep": 5, "sweep/census_band": 5}, H),
            ("config7_affine", lambda: _config7_run(c7_left, c7_right, dev, "affine"),
             {"sweep": 5, "sweep/census_band": 5}, H),
            # cli-em-1024: the CLI frame's kernels, then the refiner at 21x21
            ("cli_em", cli_em, {"sweep": 6, "sweep/band": 6, "speckle": 11}, H))
    counts = {}
    for what, run, want, hw in runs:
        want = {**none, "speckle": 9, **want}
        _reset_counts()
        dm = run()
        torch.cuda.synchronize()
        counts[what] = _read_counts()
        print(f"[main] {what}: launches {counts[what]}")
        if counts[what]["sweep"]:
            print(f"[main] {what}: of {counts[what]['sweep']} sweep launches "
                  f"{counts[what]['sweep/band']} on band_sweep_kernel, "
                  f"{counts[what]['sweep/census_band']} on band_census_kernel")
        if what.startswith("cli_log"):
            lv_plan = plan if what == "cli_log_timeout" else None
            ring0 = int(what == "cli_log_parabola")
            print(f"[main] {what}: sweep kernel by level (level, window, kernel): "
                  + ", ".join(f"{lv}: {sx}x{sy} {k}"
                              for lv, sx, sy, k in _cli_level_kernels(ring0, lv_plan)))
        _sanity(dm, what, hw, hw)
        if counts[what] != want:
            raise SystemExit(f"{what}: expected launches {want}, got {counts[what]}")
    shutil.rmtree(folder)
    # config5-mosaic-1024: plain tensor work, no kernel of csrc/
    counts["config5"] = _config5_main(dev)
    # configs 1 and 2: plain tensor work; cli-match-1024: the CLI frame's
    # kernels after the pre-alignment
    counts["config1"] = _config1_main(dev)
    counts["config2"] = _config2_main(dev)
    counts["cli_match"] = _cli_match_main(dev)
    # config8-1024 and ipfind's SIFT-class chains: plain tensor work
    counts["config8"], counts["sift_chains"] = _config8_main(dev)
    return counts


def _config5(n):
    """(sources, their georefs, the canvas georef) of config 5 at n^2."""
    from visionworkbench_torch.cartography.georeference import GeoReference

    def georef(scale, x0, y0):
        return GeoReference(transform=np.array([[scale, 0.0, x0], [0.0, -scale, y0],
                                                [0.0, 0.0, 1.0]]))
    tex = _texture(n, n, CONFIG7_SEED)
    sh = int(n * 0.6)
    srcs = [tex[:sh, i * 7:i * 7 + sh] + np.float32(i * 1e-4) for i in range(4)]
    specs = [(sc, x * n * 0.01, y * n * 0.01) for sc, x, y in C5_SPECS]
    return srcs, [georef(*sp) for sp in specs], georef(0.01, 0.0, n * 0.01)


def _config5_plans(georefs, dst, n):
    from visionworkbench_torch.mosaic.geomosaic import plan_reproject_grids
    return plan_reproject_grids(georefs, dst, (n, n))


def _config5_run(srcs, georefs, dst, plans, n, dev):
    from visionworkbench_torch.mosaic.geomosaic import reproject_mosaic
    return reproject_mosaic(srcs, georefs, dst, (n, n), levels=C5_LEVELS, plans=plans,
                            device=dev)


def _config5_check(srcs, plans, out, valid, n, dev):
    """Phase 3's checks of a config-5 mosaic: ``valid`` is the union of the
    plans' masks, the mosaic is finite, and wherever one source alone
    covers every pixel within 2^(levels + 2) px (the reach of the pyramid's
    blurs and upsamples; the canvas's outside counts as not covered) the
    mosaic equals that source's warp within 1e-4."""
    import torch
    import torch.nn.functional as F
    from visionworkbench_torch.image.transform import warp_route, warp_with
    prepared = [p.prepare(s.shape, (n, n), "bilinear", dev) for s, p in zip(srcs, plans)]
    routes = [warp_route(*p) for p in plans]
    print(f"[main] config5 {n}^2: coordinate routes {routes}, grid steps "
          f"{[p[2] for p in plans]}")
    union = torch.zeros((n, n), dtype=torch.bool, device=dev)
    cover = torch.zeros((n, n), dtype=torch.int32, device=dev)
    for _, mask, _ in prepared:
        union |= mask
        cover += mask.to(torch.int32)
    if not torch.equal(valid, union):
        raise SystemExit(f"config5 {n}^2: valid differs from the union of the plans' masks "
                         f"at {int((valid != union).sum())} pixels")
    if not bool(torch.isfinite(out).all()):
        raise SystemExit(f"config5 {n}^2: the mosaic has non-finite values")
    r = 2 ** (C5_LEVELS + 2)
    cores, err = [], 0.0
    for src, (coords, mask, _) in zip(srcs, prepared):
        bad = F.pad((~(mask & (cover == 1))).to(torch.float32)[None, None], (r, r, r, r),
                    value=1.0)
        bad = F.max_pool2d(F.max_pool2d(bad, (1, 2 * r + 1), 1), (2 * r + 1, 1), 1)[0, 0]
        core = bad == 0
        warp = warp_with(torch.as_tensor(src, device=dev), coords, "bilinear", "zero")
        cores.append(int(core.sum()))
        if cores[-1]:
            err = max(err, float((out - warp).abs()[core].max()))
    print(f"[main] config5 {n}^2: valid {valid.float().mean().item():.4f}; pixels with "
          f"one source alone within {r} px, per source: {cores}; max |mosaic - that "
          f"source's warp| there {err}")
    if not all(cores) or err > 1e-4:
        raise SystemExit(f"config5 {n}^2: the mosaic differs from a lone source's warp "
                         f"({err}) or a source has no such pixel ({cores})")
    return routes


def _config5_main(dev, n=H):
    """config5-mosaic-1024: the launch counts around one mosaic (no kernel
    of csrc/ is on this path), then phase 3's checks."""
    import torch
    srcs, georefs, dst = _config5(n)
    plans = _config5_plans(georefs, dst, n)
    srcs = [torch.as_tensor(s, device=dev) for s in srcs]
    _reset_counts()
    out, valid = _config5_run(srcs, georefs, dst, plans, n, dev)
    torch.cuda.synchronize()
    counts = _read_counts()
    print(f"[main] config5: launches {counts}")
    if any(counts.values()):
        raise SystemExit(f"config5: a kernel of csrc/ ran on the mosaic's path: {counts}")
    if tuple(out.shape) != (n, n):
        raise SystemExit(f"config5: mosaic of shape {tuple(out.shape)}")
    routes = _config5_check(srcs, plans, out, valid, n, dev)
    if n >= 1024 and set(routes) != {"separable"}:
        raise SystemExit(f"config5 {n}^2: expected the 1-D route for every source: {routes}")
    return counts


# ---- configs 1 and 2, cli-match-1024 ------------------------------------------

def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class _env:
    """Set an environment variable for a ``with`` block, then restore it
    (the port reads its switches on every call)."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        import os
        self.prev = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        import os
        if self.prev is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.prev


def _config1_run(img, dev):
    """Config 1: the Gaussian blur, then the pyramid's blur-downsamples."""
    import torch
    from visionworkbench_torch.image.filters import gaussian_filter
    from visionworkbench_torch.stereo.pyramid_correlation import _blur_downsample
    out = [gaussian_filter(torch.as_tensor(img, device=dev), C1_SIGMA)]
    for _ in range(C1_LEVELS):
        out.append(_blur_downsample(out[-1]))
    return out


def _config1_main(dev, n=H):
    """config1-1024: the launch counts around one pyramid (no kernel of
    csrc/ is on this path), its shapes, and card = CPU bit for bit (every
    tap a multiply and an add of its own)."""
    import torch
    img = _texture(n, n, CONFIG7_SEED)[:, :n]
    t = torch.as_tensor(img, device=dev)
    _reset_counts()
    out = _config1_run(t, dev)
    _sync(dev)
    counts = _read_counts()
    print(f"[main] config1: launches {counts}")
    if any(counts.values()):
        raise SystemExit(f"config1: a kernel of csrc/ ran on the pyramid's path: {counts}")
    shapes = [tuple(o.shape) for o in out]
    want = [(-(-n // (1 << i)),) * 2 for i in range(C1_LEVELS + 1)]
    cpu = _config1_run(img, "cpu")
    same = [torch.equal(a.cpu(), b) for a, b in zip(out, cpu)]
    print(f"[main] config1 {n}^2: levels {shapes}; card = CPU per level: {same}")
    if shapes != want or not all(same):
        raise SystemExit(f"config1: shapes {shapes} (want {want}) or card != CPU {same}")
    return counts


def _config2_pair(n):
    """Config 2's pair: tex[:, :n] and tex[:, 16:16 + n] of the texture of
    seed 11, so a left point at x matches the right one at x - 16."""
    tex = _texture(n, n, CONFIG7_SEED)
    return tex[:, :n].copy(), tex[:, 16:16 + n].copy()


def _config2_run(a, b, dev):
    """Config 2: upright single-scale Harris (512 points, threshold 1e-8),
    upright sgrad descriptors, ratio-test matching."""
    from visionworkbench_torch.interest import describe, detect_points, match_points
    pa = describe(a, detect_points(a, "harris", max_points=C2_POINTS,
                                   threshold=C2_THRESHOLD, device=dev), upright=True)
    pb = describe(b, detect_points(b, "harris", max_points=C2_POINTS,
                                   threshold=C2_THRESHOLD, device=dev), upright=True)
    return pa, pb, match_points(pa, pb, ratio=C2_RATIO)


def _point_share(ref, got, tol=1e-3):
    """Share of ``ref``'s valid points with a ``got`` point within ``tol`` px."""
    r, g = ref.to_numpy(), got.to_numpy()
    a = np.stack([r["x"], r["y"]], -1)
    b = np.stack([g["x"], g["y"]], -1)
    near = np.full(len(a), np.inf)
    for i in range(0, len(a), 256):
        near[i:i + 256] = np.sqrt(((a[i:i + 256, None] - b[None]) ** 2).sum(-1)).min(1)
    return float((near <= tol).mean()), len(a)


def _check_matches(what, pa, pb, m, n):
    """At least 50 ok matches, >= 0.9 of them within 0.5 px of the pair's
    shift (16, 0)."""
    from visionworkbench_torch.interest.matcher import matched_coordinates
    c1, c2 = matched_coordinates(pa, pb, m)
    d = c1 - c2
    good = (np.abs(d[:, 0] - 16.0) <= 0.5) & (np.abs(d[:, 1]) <= 0.5)
    share = float(good.mean()) if len(d) else 0.0
    print(f"[main] {what} {n}^2: {pa.count()} and {pb.count()} points, {len(d)} ok "
          f"matches, {share:.4f} of them within 0.5 px of (16, 0)")
    if len(d) < 50 or share < 0.9:
        raise SystemExit(f"{what}: {len(d)} matches, {share:.4f} within 0.5 px of the shift")


def _config2_main(dev, n=H):
    """config2-1024: the launch counts around one pair (no kernel of csrc/),
    the sanity of the matches (>= 0.9 of them within 0.5 px of the pair's
    shift), then card against CPU: ``_peaks_to_points`` on one shared
    response map (the whole tuple equal), the point sets by share (>= 0.99
    of the CPU's points within 1e-3 px) and the ok match counts within 1 %."""
    import torch
    from visionworkbench_torch.interest import detector, harris_interest
    a, b = _config2_pair(n)
    ta, tb = (torch.as_tensor(x, device=dev) for x in (a, b))
    _reset_counts()
    pa, pb, m = _config2_run(ta, tb, dev)
    _sync(dev)
    counts = _read_counts()
    print(f"[main] config2: launches {counts}")
    if any(counts.values()):
        raise SystemExit(f"config2: a kernel of csrc/ ran on the matcher's path: {counts}")
    _check_matches("config2", pa, pb, m, n)
    resp = harris_interest(a, device="cpu")
    for k in (C2_POINTS, ((n + 1) // 2) ** 2):
        cpu = detector._peaks_to_points(resp, C2_THRESHOLD, k)
        card = detector._peaks_to_points(resp.to(dev), C2_THRESHOLD, k)
        same = [torch.equal(x, y.cpu()) for x, y in zip(cpu, card)]
        print(f"[slice] config2 _peaks_to_points on one response, {k} slots: card = CPU "
              f"(x, y, interest, valid): {same}")
        if not all(same):
            raise SystemExit("config2: _peaks_to_points differs card vs CPU")
    qa, qb, mc = _config2_run(a, b, "cpu")
    shares = [_point_share(c, g) for c, g in ((qa, pa), (qb, pb))]
    ok_gpu, ok_cpu = int(m.valid.sum()), int(mc.valid.sum())
    print(f"[slice] config2 {n}^2: CPU points with a card point within 1e-3 px "
          f"{shares}; ok matches card {ok_gpu}, CPU {ok_cpu}")
    if min(s for s, _ in shares) < 0.99 or abs(ok_gpu - ok_cpu) > 0.01 * ok_cpu:
        raise SystemExit("config2: card and CPU point sets or match counts differ")
    return counts


def _rotation(n, degrees=MATCH_ROTATION_DEG):
    from visionworkbench_torch.math.transform2d import RotateTransform
    return RotateTransform(np.radians(degrees), ((n - 1) / 2.0, (n - 1) / 2.0))


def _cli_match_files(n, dev, folder):
    """cli-match's pair as float32 TIFFs: the bench pair's left image and its
    right image rotated by MATCH_ROTATION_DEG about its centre
    (``image/transform.rotate``); also the exact match file, right points
    first (see ``MATCH_ORDER``): 200 correspondences under the true map
    (left -> rotated right: the shift, then the rotation) and 50 right
    points at least 50 px off it."""
    import os
    import torch
    from visionworkbench_torch.fileio import write_tiff
    from visionworkbench_torch.image.transform import rotate
    from visionworkbench_torch.interest.io import write_binary_match_file
    left, right = _make_pair(n, n)
    right = rotate(torch.as_tensor(right, device=dev), np.radians(MATCH_ROTATION_DEG))
    paths = [os.path.join(folder, f) for f in ("left.tif", "right.tif", "exact.match")]
    write_tiff(paths[0], left)
    write_tiff(paths[1], right.cpu().numpy())
    rng = np.random.default_rng(17)
    p_left = rng.random((250, 2)) * (n - 1)
    q = np.hstack([p_left + [16.0, 0.0], np.ones((250, 1))]) @ _rotation(n).matrix.T
    p_right = q[:, :2] / q[:, 2:]
    off = rng.random((50, 2)) * 60 + 40                     # >= 56 px off
    p_right[200:] += off * rng.choice([-1.0, 1.0], (50, 2))
    write_binary_match_file(paths[2], {"x": p_right[:, 0], "y": p_right[:, 1]},
                            {"x": p_left[:, 0], "y": p_left[:, 1]})
    return paths


def _tool(main, argv, dev):
    """(exit code, printed text, wall seconds) of one of the port's CLIs."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, device=dev)
    wall = time.perf_counter() - t0
    return rc, buf.getvalue(), wall


def _cli_match_chain(paths, dev, folder, match=None, first=1):
    """ipfind (harris, single scale) on both images, ipmatch (similarity
    RANSAC) on image ``first`` and then the other (1: right first, the order
    the pre-alignment aligns; 0: left first, as ipmatch is usually run),
    then correlate --match-file (``match``: the exact file instead of
    ipmatch's): {tool: (printed text, wall s)}, the DisparityMap read back
    from the output TIFF, and the match file."""
    import os
    import torch
    from visionworkbench_torch.fileio import read_tiff
    from visionworkbench_torch.stereo.correlation import DisparityMap
    from visionworkbench_torch.tools import correlate, ipfind, ipmatch
    out = {}
    if match is None:
        order = [paths[first], paths[1 - first]]
        for name, main, argv in (
                ("ipfind", ipfind.main, [*paths[:2], *MATCH_IPFIND]),
                ("ipmatch", ipmatch.main, [*order, "--output-prefix",
                                           os.path.join(folder, "")])):
            rc, text, wall = _tool(main, argv, dev)
            if rc != 0:
                raise SystemExit(f"cli_match: {name} failed: {text}")
            out[name] = (text, wall)
        stems = (os.path.splitext(os.path.basename(p))[0] for p in order)
        match = os.path.join(folder, "__".join(stems) + ".match")
    prefix = os.path.join(folder, "disparity")
    rc, text, wall = _tool(correlate.main, [*paths[:2], "--match-file", match, "-o", prefix,
                                            *MATCH_CORRELATE], dev)
    if rc != 0:
        raise SystemExit(f"cli_match: correlate failed: {text}")
    out["correlate"] = (text, wall)
    disp, _ = read_tiff(prefix + ".tif")
    return out, DisparityMap(torch.as_tensor(disp[..., :2]), torch.as_tensor(disp[..., 2] > 0.5)), match


def _inliers(text):
    m = re.search(r"Pre-alignment homography from (\d+) inliers", text)
    if m is None:
        raise SystemExit(f"cli_match: correlate printed no pre-alignment: {text}")
    return int(m.group(1))


def _prealign_error(match, n, dev):
    """The largest distance over the frame between the pre-alignment that
    ``match`` gives and the true map: |T^-1(R(x + s)) - x|, T the homography
    correlate fits (the same ransac call), R the rotation and s the bench
    shift (the warp samples the rotated right image at T x, and left(x) =
    rotated(R(x + s)))."""
    from visionworkbench_torch.interest.io import read_binary_match_file
    from visionworkbench_torch.math.ransac import ransac
    d1, d2 = read_binary_match_file(match)
    t, _ = ransac(np.stack([d2["x"], d2["y"]], -1), np.stack([d1["x"], d1["y"]], -1),
                  "homography", 10.0, 100, device=dev)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    r = _rotation(n).matrix
    q = np.stack([xx + 16.0, yy, np.ones_like(xx)], -1) @ r.T @ np.linalg.inv(t.matrix).T
    d = np.stack([q[..., 0] / q[..., 2] - xx, q[..., 1] / q[..., 2] - yy], -1)
    return float(np.sqrt((d ** 2).sum(-1)).max())


def _true_share(dm, n):
    """The interior's (a margin of n / 16) valid share, and the share of its
    valid pixels whose disparity is within 0.5 px of the true map's in both
    components: 0, since the true pre-alignment leaves left(x) = warped(x)."""
    d, v = dm.to_numpy()
    m = n // 16
    core = np.s_[m:-m, m:-m]
    ok = (np.abs(d) <= 0.5).all(-1)[core][v[core]]
    return float(v[core].mean()), float(ok.mean()) if ok.size else 0.0


def _check_chain(dm, match, n, dev, what, bound):
    """>= 0.9 of the valid interior within 0.5 px of the true disparity, and
    the pre-alignment within ``bound`` px of the true map."""
    valid, share = _true_share(dm, n)
    err = _prealign_error(match, n, dev)
    print(f"[main] {what} {n}^2: pre-alignment within {err:.4f} px of the true map "
          f"(bound {bound}); interior valid {valid:.4f}, within 0.5 px of the true "
          f"disparity {share:.4f}")
    if valid < 0.5 or share < 0.9 or err > bound:
        raise SystemExit(f"{what}: {share:.4f} of the valid interior within 0.5 px, "
                         f"pre-alignment {err:.4f} px off the true map")


def _match_levels(n=H):
    """The coarsest level of correlate --match-file's frame (the CLI's
    defaults on MATCH_SEARCH)."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import max_pyramid_levels_for
    return max_pyramid_levels_for(n, n, CLI_KERNEL, BBox2i(*MATCH_SEARCH), CLI_LEVELS)


def _match_launches(n=H):
    """The launches of correlate --match-file's frame: one abs sweep a level
    on band_sweep_kernel (levels as the CLI's defaults and MATCH_SEARCH
    give them), two speckle passes a level above 0 and one at 0."""
    from visionworkbench_torch.ops import sweep
    from visionworkbench_torch.stereo.pyramid_correlation import level_searches
    levels = _match_levels(n)
    plan = level_searches(n, n, levels, MATCH_SEARCH[2:], 11, None, 0.0, None)
    print("[main] cli_match: sweep kernel by level (level, window, kernel): " + ", ".join(
        f"{lv}: {sx}x{sy} band_sweep_kernel<abs, {sweep._sweep_variant('abs', TILE, sx, sy, *CLI_KERNEL, 0)}>"
        for lv, _, _, sx, sy in plan))
    return {"sweep": levels + 1, "sweep/band": levels + 1, "speckle": 2 * levels + 1}


def _cli_match_main(dev, n=H):
    """cli-match-1024: the chain a user runs (ipfind -> ipmatch -> correlate
    --match-file) with the launch counts set to 0 before it (only the
    correlation launches kernels of csrc/), then the CLI once more on the
    exact match file (its printed inlier count 200), each held against the
    true map; then the chain on ipmatch's (left, right) file, which must
    fail the gate while the pre-alignment is the JAX package's."""
    folder = tempfile.mkdtemp(prefix="chip_smoke_cli_match_")
    paths = _cli_match_files(n, dev, folder)
    _reset_counts()
    out, dm, match = _cli_match_chain(paths, dev, folder)
    _sync(dev)
    counts = _read_counts()
    print(f"[main] cli_match: launches {counts}; " + "; ".join(
        f"{k} {w:.4f} s: {t.strip().splitlines()[-1]}" for k, (t, w) in out.items()))
    want = {**{k: 0 for k in counts}, **_match_launches(n)}
    if counts != want:
        raise SystemExit(f"cli_match: expected launches {want}, got {counts}")
    _check_chain(dm, match, n, dev, "cli_match", MATCH_PREALIGN_BOUND)
    out2, dm2, _ = _cli_match_chain(paths, dev, folder, paths[2])
    k = _inliers(out2["correlate"][0])
    print(f"[main] cli_match exact file (200 correspondences, 50 outliers): {k} inliers")
    if k != 200:
        raise SystemExit(f"cli_match: {k} inliers printed on the exact file, not 200")
    _check_chain(dm2, paths[2], n, dev, "cli_match exact", MATCH_EXACT_BOUND)
    _, dm3, match3 = _cli_match_chain(paths, dev, folder, first=0)
    valid, share = _true_share(dm3, n)
    print(f"[main] cli_match left-first ({match3.rsplit('/', 1)[-1]}; ROADMAP section 3): "
          f"pre-alignment within {_prealign_error(match3, n, dev):.4f} px of the true "
          f"map; interior valid {valid:.4f}, within 0.5 px of the true disparity "
          f"{share:.4f} (must stay under 0.9)")
    if share >= 0.9:
        raise SystemExit("cli_match left-first: the pre-alignment now aligns an ipmatch "
                         "(left, right) file; the fault in ROADMAP section 3 is fixed: "
                         "update this check and that entry")
    shutil.rmtree(folder)
    return counts



def _config8_run(a, b, dev):
    """Config 8: detect_sift_like (DoG, C8_POINTS points) on both images,
    ratio-test matching."""
    from visionworkbench_torch.interest import detect_sift_like, match_points
    pa = detect_sift_like(a, max_points=C8_POINTS, device=dev)
    pb = detect_sift_like(b, max_points=C8_POINTS, device=dev)
    return pa, pb, match_points(pa, pb, ratio=C8_RATIO)


def _angle_diff(a, b):
    d = (a.cpu() - b.cpu()).abs().numpy()
    return np.minimum(d, 2 * np.pi - d)


def _sift_vs_cpu(dev, n):
    """Both routes of detect_sift_like (``VWTPU_SIFT_GATHER`` 0 and 1) on
    config 8's pair at n^2, card against CPU: the points equal, the
    orientations within 1e-4 rad on >= 0.99 of the valid points, the
    descriptors of >= 0.99 of the agreeing points within 1e-4 and all within
    0.1 in L2, the ok match counts within 1 %. The card's atan2 / sqrt /
    exp / cos / sin and its sums' order differ from the CPU's by ulps, so an
    orientation moves by ~1e-7 rad and a gradient angle within that of a
    bin edge lands in the other bin (a descriptor moves by ~0.03)."""
    import torch
    a, b = _config2_pair(n)
    for route in ("0", "1"):
        with _env("VWTPU_SIFT_GATHER", route):
            card = _config8_run(*(torch.as_tensor(x, device=dev) for x in (a, b)), dev)
            cpu = _config8_run(a, b, "cpu")
        for g, c in zip(card[:2], cpu[:2]):
            same = all(torch.equal(getattr(g, f).cpu(), getattr(c, f))
                       for f in ("x", "y", "interest", "valid"))
            v = c.valid.numpy()
            agree = _angle_diff(g.orientation, c.orientation)[v] <= 1e-4
            dd = (g.descriptor.cpu() - c.descriptor).numpy()[v][agree]
            within = float((np.abs(dd).max(1) <= 1e-4).mean())
            l2 = float(np.linalg.norm(dd, axis=1).max())
            print(f"[slice] config8 {n}^2 VWTPU_SIFT_GATHER={route}: points card = CPU {same}, "
                  f"{int(v.sum())} valid, orientations within 1e-4 rad {agree.mean():.4f} "
                  f"(max |d| {float(_angle_diff(g.orientation, c.orientation)[v].max())!r}), "
                  f"descriptors of those within 1e-4 {within:.4f} (max |d| "
                  f"{float(np.abs(dd).max())!r}, max L2 {l2!r})")
            if not same or agree.mean() < 0.99 or within < 0.99 or l2 > 0.1:
                raise SystemExit(f"slice config8 route {route}: card and CPU disagree")
        ok_gpu, ok_cpu = int(card[2].valid.sum()), int(cpu[2].valid.sum())
        print(f"[slice] config8 {n}^2 VWTPU_SIFT_GATHER={route}: ok matches card {ok_gpu}, "
              f"CPU {ok_cpu}")
        if abs(ok_gpu - ok_cpu) > 0.01 * ok_cpu:
            raise SystemExit(f"slice config8 route {route}: ok match counts differ")


def _obalog_vs_cpu(dev, n):
    """detect_points_obalog at n^2: >= 0.99 of the CPU's points within
    1e-3 px of a card point (float64 integral images: the card's parallel
    scan and the CPU's sequential one round the box sums alike)."""
    import torch
    from visionworkbench_torch.interest import detect_points_obalog
    img = _config2_pair(n)[0]
    card = detect_points_obalog(torch.as_tensor(img, device=dev))
    cpu = detect_points_obalog(img, device="cpu")
    share, k = _point_share(cpu, card)
    print(f"[slice] obalog {n}^2: {k} CPU points, {card.count()} card points, share within "
          f"1e-3 px {share:.4f}")
    if share < 0.99:
        raise SystemExit("slice obalog: card and CPU points differ")


def _sift_chain(paths, dev, folder, find_args, match_args):
    """ipfind (``find_args``) on both images, ipmatch right left
    (``match_args``): {tool: (printed text, wall s)} and the match file."""
    import os
    from visionworkbench_torch.tools import ipfind, ipmatch
    out = {}
    for name, main, argv in (
            ("ipfind", ipfind.main, [*paths[:2], *find_args]),
            ("ipmatch", ipmatch.main, [paths[1], paths[0], "--output-prefix",
                                       os.path.join(folder, ""), *match_args])):
        rc, text, wall = _tool(main, argv, dev)
        if rc != 0:
            raise SystemExit(f"sift chain: {name} failed: {text}")
        out[name] = (text, wall)
    return out, os.path.join(folder, "right__left.match")


def _sift_chains(dev, n):
    """ipfind with its default operator (sift) and with obalog on
    cli-match's TIFFs, then ipmatch right left (C8_CHAINS), on the CPU
    first and then on the card (each in a folder of its own): points,
    matches and wall times printed; in the gated chains the RANSAC
    pre-alignment held against the true map. The card's bound:
    MATCH_PREALIGN_BOUND, or the CPU's error plus 0.05 px where the CPU's
    chain does not reach it."""
    import os
    import torch
    folders = [tempfile.mkdtemp(prefix=f"chip_smoke_sift_{d}_") for d in ("cpu", "card")]
    paths = _cli_match_files(n, dev, folders[1])
    for f in ("left.tif", "right.tif"):
        shutil.copy(os.path.join(folders[1], f), folders[0])
    cpu_paths = [os.path.join(folders[0], os.path.basename(p)) for p in paths]
    result = {}
    for op, find_args, match_args, gated in C8_CHAINS:
        errs = []
        for d, pp, folder in (("cpu", cpu_paths, folders[0]), (dev, paths, folders[1])):
            out, match = _sift_chain(pp, d, folder, find_args, match_args)
            err = _prealign_error(match, n, d) if gated else None
            errs.append(err)
            points = [int(x) for x in re.findall(r"(\d+) interest points", out["ipfind"][0])]
            found = re.findall(r"Found (\d+) putative matches", out["ipmatch"][0])
            kept = re.findall(r"RANSAC kept (\d+) matches", out["ipmatch"][0])
            print(f"[main] ipfind {op} ({torch.device(d).type}): points {points}, "
                  f"{' '.join(['ipmatch right left', *match_args])}: {found[-1]} putative matches, "
                  f"{kept[-1] if kept else 'RANSAC failed:'} inliers, wall ipfind "
                  f"{out['ipfind'][1]:.4f} s, ipmatch {out['ipmatch'][1]:.4f} s"
                  + ("" if err is None else f"; pre-alignment within {err:.4f} px of the "
                     "true map"))
            result[f"{op}_{torch.device(d).type}"] = {
                "ipfind_s": out["ipfind"][1], "ipmatch_s": out["ipmatch"][1],
                "matches": int(found[-1]), "err_px": err}
        if not gated:
            continue
        bound = (MATCH_PREALIGN_BOUND if errs[0] <= MATCH_PREALIGN_BOUND
                 else errs[0] + 0.05)
        print(f"[main] ipfind {op} chain: card {errs[1]:.4f} px, CPU {errs[0]:.4f} px "
              f"(card bound {bound:.4f})")
        if not errs[1] <= bound:
            raise SystemExit(f"ipfind {op} chain: pre-alignment {errs[1]:.4f} px off the true map")
    for f in folders:
        shutil.rmtree(f)
    return result


def _config8_main(dev, n=H):
    """config8-1024: the launch counts around one pair (no kernel of csrc/),
    the sanity of the matches, then card against CPU: detect_points_dog at
    n^2 (x, y, interest, valid equal, scale within 1e-6 relative), both
    routes of detect_sift_like at n/2, OBALoG at n/4, and ipfind's sift and
    obalog chains."""
    import torch
    from visionworkbench_torch.interest import detect_points_dog
    a, b = _config2_pair(n)
    ta, tb = (torch.as_tensor(x, device=dev) for x in (a, b))
    _reset_counts()
    pa, pb, m = _config8_run(ta, tb, dev)
    _sync(dev)
    counts = _read_counts()
    print(f"[main] config8: launches {counts}; {pa.capacity} slots an image")
    if any(counts.values()):
        raise SystemExit(f"config8: a kernel of csrc/ ran on the SIFT path: {counts}")
    _check_matches("config8", pa, pb, m, n)
    card = detect_points_dog(ta, max_points=C8_POINTS)
    cpu = detect_points_dog(a, max_points=C8_POINTS, device="cpu")
    same = [torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
            for f in ("x", "y", "interest", "valid")]
    rel = float(((card.scale.cpu() - cpu.scale).abs() / cpu.scale).max())
    print(f"[slice] config8 detect_points_dog {n}^2: card = CPU (x, y, interest, valid) "
          f"{same}; scale max relative |d| {rel!r}")
    if not all(same) or rel > 1e-6:
        raise SystemExit("config8: detect_points_dog differs card vs CPU")
    _sift_vs_cpu(dev, n // 2)
    _obalog_vs_cpu(dev, n // 4)
    return counts, _sift_chains(dev, n)


# ---- phase 4 ----------------------------------------------------------------

def _masks(h, w, seed):
    """A left mask with one masked block and a right mask with 3 % of its
    pixels masked (as the CPU tests' masked cases)."""
    rng = np.random.default_rng(seed)
    lm = np.ones((h, w), bool)
    lm[h // 5:h // 3, w // 10:w // 2] = False
    return lm, rng.random((h, w)) < 0.97


def _check_mean_fill(img, mask, dev):
    """The masked pixels' fill (the mean of the even-index valid pixels) on
    the card and on the CPU: allclose at rtol 1e-6, since its sum runs in
    another order on each device."""
    import torch
    from visionworkbench_torch.stereo.pyramid_correlation import _mean_fill
    h, w = img.shape
    y, x = np.argwhere(~mask)[0]            # a masked pixel
    fills = [float(_mean_fill(torch.as_tensor(img, device=d),
                              torch.as_tensor(mask, device=d), h, w)[y, x])
             for d in (dev, "cpu")]
    print(f"[slice] mean fill {h}x{w}: card {fills[0]!r}, cpu {fills[1]!r}")
    if not np.isclose(fills[0], fills[1], rtol=1e-6, atol=0):
        raise SystemExit(f"slice: mean fill differs GPU vs CPU: {fills}")


def _log_pyramid(img, levels):
    """The CLI frame's pyramid of one image: edge-extended by the kernel's
    half width at the coarsest scale, blurred and halved ``levels`` times,
    each level LoG-prefiltered (as ``pyramid_correlate`` builds it)."""
    from visionworkbench_torch.image.edge import crop_extended
    from visionworkbench_torch.stereo.prefilter import prefilter_image
    from visionworkbench_torch.stereo.pyramid_correlation import _blur_downsample
    pad = CLI_KERNEL[0] // 2 << levels
    h, w = img.shape
    pyr = [crop_extended(img, -pad, -pad, w + 2 * pad, h + 2 * pad)]
    for _ in range(levels):
        pyr.append(_blur_downsample(pyr[-1]))
    return [prefilter_image(p, CLI["prefilter_mode"], CLI["prefilter_width"]) for p in pyr]


def _cli_vs_cpu(dev):
    """The CLI frame's path at 256^2 on the card and on the CPU (plain
    versions), on the bench texture (off the 1/256 grid, as the LoG images
    are): the prefiltered pyramids, ``remove_small_blobs`` and whole LoG
    frames (every level's map with the blob filter and keep_levels), all
    bit for bit."""
    import torch
    from visionworkbench_torch.image.morphology import remove_small_blobs
    left, right = _make_pair(256, 256)
    for name, img in (("left", left), ("right", right)):
        g = _log_pyramid(torch.as_tensor(img, device=dev), 3)
        c = _log_pyramid(torch.as_tensor(img), 3)
        diff = [int((a.cpu() != b).sum()) for a, b in zip(g, c)]
        print(f"[slice] cli LoG pyramid ({name}, levels {[tuple(a.shape) for a in c]}): "
              f"pixels differing card vs cpu {diff}")
        if any(diff):
            raise SystemExit("slice cli: the prefiltered pyramids differ card vs CPU")
    outs = {}
    for what, kw in (("log", {}),
                     ("log blob+keep_levels", dict(blob_filter_area=CLI_BLOB_AREA,
                                                    keep_levels=True))):
        res = [_cli_run(left, right, d, **kw) for d in (dev, "cpu")]
        maps = [r.level_disparities + [r.disparity] if "keep" in what else [r]
                for r in res]
        outs[what] = res
        for i, (g, c) in enumerate(zip(*maps)):
            (dg, vg), (dc, vc) = g.to_numpy(), c.to_numpy()
            print(f"[slice] cli {what} 256^2 map {i}: valid {vg.mean():.4f}, validity "
                  f"differs at {int((vg != vc).sum())} pixels, max |gpu - cpu| "
                  f"{float(np.abs(dg - dc).max())}")
            if not (np.array_equal(vg, vc) and np.array_equal(dg, dc)):
                raise SystemExit(f"slice cli {what}: GPU and CPU outputs differ")
    mask = outs["log"][1].valid
    for conn in (4, 8):
        kg = remove_small_blobs(mask.to(dev), CLI_BLOB_AREA, conn).cpu()
        kc = remove_small_blobs(mask, CLI_BLOB_AREA, conn)
        print(f"[slice] remove_small_blobs 256^2 ({conn}-connected, area "
              f"{CLI_BLOB_AREA}): keeps {int(kc.sum())} of {int(mask.sum())}, differs "
              f"card vs cpu at {int((kg != kc).sum())} pixels")
        if not torch.equal(kg, kc):
            raise SystemExit("slice cli: remove_small_blobs differs card vs CPU")


def _diff(a, b):
    """(share of pixels whose validity agrees, |da - db| on pixels valid in
    both) of two disparity maps."""
    (da, va), (db, vb) = a.to_numpy(), b.to_numpy()
    return (va == vb).mean(), np.abs(da - db).max(-1)[va & vb]


def _describe(agree, dd, within):
    return (f"validity agrees {agree:.6f}, |d| on pixels valid in both: median "
            f"{float(np.median(dd))!r}, p99 {float(np.percentile(dd, 99))!r}, max "
            f"{float(dd.max())!r}, within {within}: {(dd <= within).mean():.6f}")


def _held(what, card, cpu, valid_share, within, share, ulp=None, max_median=None):
    """Card against CPU of a refined map: validity agreeing on at least
    ``valid_share`` of the pixels and, on pixels valid in both, at least
    ``share`` of them within ``within`` px (and their median |d| at most
    ``max_median``). ``ulp``: the CPU's map for the left image times
    (1 + 2^-23), printed beside as the refiner's own sensitivity to a
    one-ulp change of its input."""
    agree, dd = _diff(card, cpu)
    print(f"[slice] {what}: valid {cpu.valid.float().mean().item():.4f}, gpu vs cpu "
          f"{_describe(agree, dd, within)} (held: validity >= {valid_share}, >= {share} "
          f"within {within}" + ("" if max_median is None else f", median <= {max_median}")
          + ")")
    if ulp is not None:
        print(f"[slice] {what}: cpu vs cpu with left * (1 + 2^-23) "
              f"{_describe(*_diff(ulp, cpu), within)}")
    if (agree < valid_share or (dd <= within).mean() < share
            or (max_median is not None and not np.median(dd) <= max_median)):
        raise SystemExit(f"slice {what}: card and CPU disagree")


def _quality_vs_cpu(dev):
    """The quality-subpixel slice at 256^2 on the card and on the CPU:
    config 7's frame with subpixel em and affine, ``bayes_em_subpixel`` over
    its own pyramid (2 levels; in both modes of ``VWTPU_EM_REWARP``),
    ``lk_subpixel``, ``phase_subpixel``, ``corr_eval`` (both metrics),
    ``interpolate`` (three modes) and the refiner pyramid's decimation
    (``subsample2``). The iterative refiners are held to a
    validity agreement of 99.5 % and a share of pixels within a bound (the
    card's ``exp`` and its sums' order are not the CPU's, and the stop rules
    flip on last-ulp differences); interpolation and decimation exactly."""
    import torch
    from visionworkbench_torch.image.interpolation import METHODS, interpolate
    from visionworkbench_torch.image.manipulation import subsample2
    from visionworkbench_torch.stereo import correval, subpixel_refine as refine
    from visionworkbench_torch.stereo.correlation import DisparityMap
    n = 256
    left, right = _make_pair(n, n, CONFIG7_SEED)
    runs = {sp: [_config7_run(left, right, d, sp) for d in (dev, "cpu")]
            for sp in ("em", "affine", "none")}
    _held("config7 em 256^2", *runs["em"], 0.995, 1e-3, 0.98)
    _held("config7 affine 256^2", *runs["affine"], 0.995, 1e-4, 0.99)
    integer = runs["none"][1]

    def on(d, dm):
        return DisparityMap(dm.disparity.to(d), dm.valid.to(d))
    ulp = np.float32(1 + 2**-23)
    # a smooth texture in [0, 1] at known subpixel shifts (the CPU tests'
    # scene)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)

    def tex(x, y):
        v = (np.sin(0.55 * x) * np.cos(0.43 * y) + 0.5 * np.sin(0.21 * x + 0.33 * y)
             + 0.3 * np.sin(1.3 * x) * np.sin(1.1 * y))
        return ((v + 1.8) / 3.6).astype(np.float32)
    zero = DisparityMap(torch.zeros((n, n, 2), dtype=torch.int32),
                        torch.ones((n, n), dtype=torch.bool))
    # The refiner's pyramid (defaults: 10 outer iterations a level) moves
    # ~0.2 px at p99 on a one-ulp change of its input, so its card-vs-CPU
    # bound is the median (1e-4 px) and half the pixels within 1e-3 px.
    left_t, right_t = tex(xx, yy), tex(xx - 2.3, yy - 1.25)
    seed = DisparityMap(torch.stack([torch.full((n, n), 2), torch.full((n, n), 1)], -1)
                        .to(torch.int32), zero.valid)

    # The re-warp mode (VWTPU_EM_REWARP=1) is worse conditioned still: a
    # one-ulp change of its input moves the median by 7.3e-4 px and leaves
    # 0.51 of the pixels within 1e-3 px (CPU, 256^2), so its bounds are a
    # median of 1e-3 px and 0.45 of the pixels within 1e-3 px.
    for rewarp, share, median in (("0", 0.5, 1e-4), ("1", 0.45, 1e-3)):
        with _env("VWTPU_EM_REWARP", rewarp):
            g, c, u = [refine.bayes_em_subpixel(on(d, seed), lt, right_t, (7, 7),
                                                max_pyramid_levels=2)
                       for d, lt in ((dev, left_t), ("cpu", left_t), ("cpu", left_t * ulp))]
        _held(f"bayes_em_subpixel(max_pyramid_levels=2) 256^2, smooth scene, "
              f"VWTPU_EM_REWARP={rewarp}", g, c, 0.995, 1e-3, share, u, max_median=median)
    # on config 7's texture (not normalized; the EM mixture poisons pixels)
    # the same call is ill-conditioned: printed beside its one-ulp envelope
    agree, dd = _diff(*[refine.bayes_em_subpixel(on(d, integer), left, right, (7, 7),
                                                 max_pyramid_levels=2)
                        for d in (dev, "cpu")])
    env = _diff(refine.bayes_em_subpixel(integer, left * ulp, right, (7, 7),
                                         max_pyramid_levels=2),
                refine.bayes_em_subpixel(integer, left, right, (7, 7), max_pyramid_levels=2))
    print(f"[slice] bayes_em_subpixel(max_pyramid_levels=2) 256^2, config 7's texture "
          f"(not held): gpu vs cpu {_describe(agree, dd, 1e-3)}; cpu vs cpu with left * "
          f"(1 + 2^-23) {_describe(*env, 1e-3)}")
    left_t, right_t = tex(xx, yy), tex(xx - 0.3, yy + 0.2)
    _held("lk_subpixel 256^2 (7x7, 5 iterations)", *[
        refine.lk_subpixel(on(d, zero), left_t, right_t, (7, 7)) for d in (dev, "cpu")], 1.0, 1e-4, 1.0)
    left_t, right_t = tex(xx, yy), tex(xx - 0.5, yy - 0.25)
    _held("phase_subpixel 256^2 (window 32, stride 8, upsample 8)", *[
        refine.phase_subpixel(on(d, zero), left_t, right_t) for d in (dev, "cpu")], 1.0, 1e-5, 0.99)
    for metric in ("ncc", "stddev"):
        qg, qc = [correval.corr_eval(on(d, integer), left, right, (7, 7), metric).cpu()
                  for d in (dev, "cpu")]
        e = float((qg - qc).abs()[32:-32, 32:-32].max())
        print(f"[slice] corr_eval {metric} 256^2 (7x7, config 7's integer map): max "
              f"|gpu - cpu| in the core {e!r}, over the frame "
              f"{float((qg - qc).abs().max())!r} (held: core within 1e-4)")
        if not e <= 1e-4:
            raise SystemExit(f"slice corr_eval {metric}: card and CPU disagree")
    rng = np.random.default_rng(72)
    img = rng.random((n, n, 3)).astype(np.float32)
    x = (rng.random((n, n)) * (n + 8) - 4).astype(np.float32)
    y = (rng.random((n, n)) * (n + 8) - 4).astype(np.float32)
    for method in METHODS:
        for im in (img, img[..., 0]):
            g, c = [interpolate(torch.as_tensor(im, device=d), x, y, method).cpu()
                    for d in (dev, "cpu")]
            diff = int((g != c).sum())
            print(f"[slice] interpolate {method} {im.shape}: {diff} values differ card vs cpu")
            if diff:
                raise SystemExit(f"slice interpolate {method}: card and CPU differ")
    g = subsample2(torch.as_tensor(img[..., 0], device=dev)).cpu()
    if not torch.equal(g, subsample2(torch.as_tensor(img[..., 0]))):
        raise SystemExit("slice subsample2: card and CPU differ")
    print("[slice] subsample2 256^2 (the refiner pyramid's decimation): equal card vs cpu")


def _config5_vs_cpu(dev, n=256):
    """The mosaic slice on the card against the plain CPU path: config 5
    at n^2 (``valid`` equal, values within 1e-5), ``warp_from_grid`` on both
    coordinate routes, ``transform`` with a rotation (within 1e-5), and the
    device grassfire of config 5's masks at 1024^2 and n^2 against
    ``grassfire_np`` (equal)."""
    import torch
    from visionworkbench_torch.image.morphology import grassfire, grassfire_np
    from visionworkbench_torch.image.transform import (
        reverse_map_grid, transform, warp_from_grid, warp_route)
    from visionworkbench_torch.math.transform2d import RotateTransform
    srcs, georefs, dst = _config5(n)
    plans = _config5_plans(georefs, dst, n)
    (go, gv), (co, cv) = (_config5_run(srcs, georefs, dst, plans, n, d) for d in (dev, "cpu"))
    e = float((go.cpu() - co).abs().max())
    print(f"[slice] config5 {n}^2: valid {cv.float().mean().item():.4f}, validity differs at "
          f"{int((gv.cpu() != cv).sum())} pixels, max |gpu - cpu| {e}")
    if not torch.equal(gv.cpu(), cv) or e > 1e-5:
        raise SystemExit(f"slice config5 {n}^2: GPU and CPU mosaics differ")
    img = _texture(n, n, CONFIG7_SEED)[:, :n]
    maps = {"separable": lambda x, y: (0.93 * x + 3.2, 1.07 * y - 2.1),
            "grid": lambda x, y: (0.98 * x + 0.05 * y + 1.0 + 1e-4 * x * y,
                                  -0.04 * x + 1.01 * y - 0.5)}
    for route, fn in maps.items():
        grid = reverse_map_grid(fn, (n, n + 7), 16)
        if warp_route(*grid) != route:
            raise SystemExit(f"slice warp_from_grid: expected the {route} route")
        for interp in ("bilinear", "bicubic"):
            g, c = (warp_from_grid(img, *grid, (n, n + 7), interp, device=d) for d in (dev, "cpu"))
            e = float((g.cpu() - c).abs().max())
            print(f"[slice] warp_from_grid {route} {interp} {n}x{n + 7}: max |gpu - cpu| {e}")
            if e > 1e-5:
                raise SystemExit(f"slice warp_from_grid {route} {interp}: GPU and CPU differ")
    g, c = (transform(img, RotateTransform(0.3, (n / 2, n / 3)), None, "bicubic", device=d)
            for d in (dev, "cpu"))
    e = float((g.cpu() - c).abs().max())
    print(f"[slice] transform (rotation 0.3, bicubic) {n}^2: max |gpu - cpu| {e}")
    if e > 1e-5:
        raise SystemExit("slice transform: GPU and CPU differ")
    for m in (H, n):
        srcs, georefs, dst = _config5(m)
        for s, p in zip(srcs, _config5_plans(georefs, dst, m)):
            mask = p.prepare(s.shape, (m, m), "bilinear", "cpu")[1].numpy()
            if not np.array_equal(grassfire(mask, device=dev).cpu().numpy(), grassfire_np(mask)):
                raise SystemExit(f"slice grassfire {m}^2: the card differs from grassfire_np")
        print(f"[slice] grassfire of config 5's four masks at {m}^2: card = grassfire_np")


def phase_slice_vs_cpu(dev):
    import torch
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    _config5_vs_cpu(dev)
    _quality_vs_cpu(dev)
    _cli_vs_cpu(dev)
    left, right = _make_pair(256, 256)
    left = np.round(left * 256) / 256
    right = np.round(right * 256) / 256
    lm, rm = _masks(256, 256, 70)
    _check_mean_fill(left, lm, dev)
    for what, kw in (("integer+lr", dict(consistency_threshold=2.0)),
                     ("parabola", dict(subpixel="parabola")),
                     ("masked integer+lr", dict(consistency_threshold=2.0, left_mask=lm,
                                                right_mask=rm))):
        outs = [pyramid_correlate(left, right, BBox2i(*SEARCH), kernel_size=KERNEL,
                                  max_pyramid_levels=2, tile_size=TILE,
                                  device=d, **kw).to_numpy()
                for d in (dev, "cpu")]
        (dg, vg), (dc, vc) = outs
        if not np.array_equal(vg, vc):
            raise SystemExit(f"slice {what}: validity differs GPU vs CPU "
                             f"({int((vg != vc).sum())} pixels)")
        if what == "parabola":
            e = float(np.abs(dg - dc).max())
            ok = np.allclose(dg, dc, rtol=0, atol=1e-4)
        else:
            e = float(np.abs(dg - dc).max())
            ok = np.array_equal(dg, dc)
        print(f"[slice] {what}: valid {vg.mean():.4f}, max |gpu - cpu| {e}")
        if not ok:
            raise SystemExit(f"slice {what}: disparities differ GPU vs CPU")
    left, right = _make_pair(128, 128)
    left = np.round(left * 256) / 256
    right = np.round(right * 256) / 256
    lm, rm = _masks(128, 128, 71)
    for algo, kw in (("sgm", {}), ("mgm", {}),
                     ("sgm masked", dict(left_mask=lm, right_mask=rm))):
        outs = [pyramid_correlate(left, right, BBox2i(*SGM_SEARCH), max_pyramid_levels=2,
                                  tile_size=TILE, stereo_algorithm=algo.split()[0],
                                  subpixel="none", device=d, **kw).to_numpy()
                for d in (dev, "cpu")]
        (dg, vg), (dc, vc) = outs
        e = float(np.abs(dg - dc).max())
        print(f"[slice] {algo} 128^2: valid {vg.mean():.4f}, validity differs at "
              f"{int((vg != vc).sum())} pixels, max |gpu - cpu| {e}")
        if not (np.array_equal(vg, vc) and np.array_equal(dg, dc)):
            raise SystemExit(f"slice {algo}: GPU and CPU outputs differ")
    left, right = _make_pair(256, 256)
    left = np.round(left * 256) / 256
    right = np.round(right * 256) / 256
    for what, kw in (("config4 integer+lr", dict(consistency_threshold=2.0)),
                     ("config4 parabola", dict(subpixel="parabola"))):
        (dg, vg), (dc, vc) = [
            pyramid_correlate(left, right, BBox2i(*SEARCH), kernel_size=KERNEL,
                              cost_type="census", census_window=CENSUS_WINDOW,
                              max_pyramid_levels=2, tile_size=TILE, device=d,
                              **kw).to_numpy()
            for d in (dev, "cpu")]
        e = float(np.abs(dg - dc).max())
        print(f"[slice] {what} 256^2: valid {vg.mean():.4f}, validity differs at "
              f"{int((vg != vc).sum())} pixels, max |gpu - cpu| {e}")
        tol = 1e-4 if "parabola" in what else 0.0
        if not (np.array_equal(vg, vc) and np.allclose(dg, dc, rtol=0, atol=tol)):
            raise SystemExit(f"slice {what}: GPU and CPU outputs differ")
    left, right = _calc3_pair(128, 128)
    left = np.round(left * 256) / 256
    right = np.round(right * 256) / 256
    for cost, cw in (("ncc", 5), ("ternary_census", 7)):
        (dg, vg), (dc, vc) = [_calc3_run(left, right, d, cost, cw).to_numpy()
                              for d in (dev, "cpu")]
        print(f"[slice] calc_disparity {cost} {cw} 128^2: valid {vg.mean():.4f}, "
              f"validity differs at {int((vg != vc).sum())} pixels, max |gpu - cpu| "
              f"{float(np.abs(dg - dc).max())}")
        if not (np.array_equal(vg, vc) and np.array_equal(dg, dc)):
            raise SystemExit(f"slice calc_disparity {cost}: GPU and CPU outputs differ")
    left, right = _make_calc_pair(128, 128)
    left = np.round(left * 256) / 256
    right = np.round(right * 256) / 256
    for use_mgm in (False, True):
        (dg, vg), (dc, vc) = [_calc_run(left, right, d, use_mgm).to_numpy()
                              for d in (dev, "cpu")]
        e = float(np.abs(dg - dc).max())
        print(f"[slice] calc_disparity_sgm{' use_mgm' if use_mgm else ''} 128^2 "
              f"{CALC_SEARCH}: valid {vg.mean():.4f}, validity differs at "
              f"{int((vg != vc).sum())} pixels, max |gpu - cpu| {e}")
        if not (np.array_equal(vg, vc) and np.allclose(dg, dc, rtol=1e-5, atol=2e-5)):
            raise SystemExit(f"slice calc_disparity_sgm (use_mgm={use_mgm}): GPU and "
                             "CPU outputs differ")


# ---- phase 5 ----------------------------------------------------------------

def _time_ms(fn, reps, warmup=2):
    """Median ms of ``fn`` over ``reps`` calls, each between CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def phase_timings(dev):
    import torch
    from visionworkbench_torch.ops import speckle, sweep
    kw, kh = KERNEL
    left, right = _make_pair(H, W)
    lt = torch.as_tensor(left, device=dev)
    rt = torch.as_tensor(right, device=dev)
    frame = {}
    for what, kwargs in (("plain", {}), ("consistency", {"consistency_threshold": 2.0})):
        ms = _time_ms(lambda: _bench_run(lt, rt, dev, **kwargs), reps=10)
        frame[what] = {"ms": ms, "mps": H * W / (ms * 1e3)}
        print(f"[time] frame {what}: {ms:.4f} ms, {H * W / (ms * 1e3):.3f} Mp/s")
    _profile_frame(lambda: _bench_run(lt, rt, dev), "bm", frame["plain"]["ms"])
    _time_cli(lt, rt, dev, frame)
    _time_quality(lt, rt, dev, frame)
    _time_config5(dev, frame)
    _time_interest(dev, frame)
    _time_sift(dev, frame)
    census = {"cost_type": "census", "census_window": CENSUS_WINDOW}
    for what, kwargs in (("config4", census),
                         ("config4_lr", {**census, "consistency_threshold": 2.0})):
        ms = _time_ms(lambda: _bench_run(lt, rt, dev, **kwargs), reps=10)
        frame[what] = {"ms": ms, "mps": H * W / (ms * 1e3)}
        print(f"[time] frame {what}: {ms:.4f} ms, {frame[what]['mps']:.3f} Mp/s")
    _profile_frame(lambda: _bench_run(lt, rt, dev, **census), "config4",
                   frame["config4"]["ms"])
    for what, kwargs in (("ncc", {"cost_type": "ncc"}),
                         ("ncc_lr", {"cost_type": "ncc", "consistency_threshold": 2.0})):
        ms = _time_ms(lambda: _bench_run(lt, rt, dev, **kwargs), reps=10)
        frame[what] = {"ms": ms, "mps": H * W / (ms * 1e3)}
        print(f"[time] frame {what}: {ms:.4f} ms, {frame[what]['mps']:.3f} Mp/s")
    _profile_frame(lambda: _bench_run(lt, rt, dev, cost_type="ncc"), "ncc", frame["ncc"]["ms"])
    c3l, c3r = (torch.as_tensor(a, device=dev) for a in _calc3_pair())
    for cost, cw in (("abs", 5), ("ncc", 5), ("census", 7)):
        what = f"calc3_{cost}" + ("7" if cost == "census" else "")
        ms = _time_ms(lambda: _calc3_run(c3l, c3r, dev, cost, cw), reps=10)
        frame[what] = {"ms": ms, "mps": H * W / (ms * 1e3)}
        print(f"[time] frame {what} (config 3, {H}^2, {CALC3_SEARCH}): {ms:.4f} ms, "
              f"{frame[what]['mps']:.3f} Mp/s")
        _profile_frame(lambda: _calc3_run(c3l, c3r, dev, cost, cw), what, ms)
    sl, sr = (torch.as_tensor(a, device=dev) for a in _make_pair(SGM_HW, SGM_HW))
    for algo in ("sgm", "mgm"):
        ms = _time_ms(lambda: _sgm_run(sl, sr, dev, algo), reps=10)
        frame[algo] = {"ms": ms, "mps": SGM_HW * SGM_HW / (ms * 1e3)}
        print(f"[time] frame {algo} (config 6, {SGM_HW}^2): {ms:.4f} ms, "
              f"{frame[algo]['mps']:.3f} Mp/s")
        _profile_frame(lambda: _sgm_run(sl, sr, dev, algo), algo, ms)
    cl, cr = (torch.as_tensor(a, device=dev) for a in _make_calc_pair(CALC_HW, CALC_HW))
    for what, use_mgm in (("calc_sgm", False), ("calc_mgm", True)):
        ms = _time_ms(lambda: _calc_run(cl, cr, dev, use_mgm), reps=5)
        frame[what] = {"ms": ms, "mps": CALC_HW * CALC_HW / (ms * 1e3)}
        print(f"[time] frame calc_disparity_sgm{' use_mgm' if use_mgm else ''} ({CALC_HW}^2, "
              f"{CALC_SEARCH}): {ms:.4f} ms, {frame[what]['mps']:.3f} Mp/s")
        _profile_frame(lambda: _calc_run(cl, cr, dev, use_mgm), what, ms)
    ms = _time_ms(lambda: _sgm_run(lt, rt, dev, "mgm"), reps=5)
    frame["mgm_1024"] = {"ms": ms, "mps": H * W / (ms * 1e3)}
    print(f"[time] frame mgm (config 6 at {H}^2): {ms:.4f} ms, "
          f"{frame['mgm_1024']['mps']:.3f} Mp/s")
    _profile_frame(lambda: _sgm_run(lt, rt, dev, "mgm"), "mgm_1024", ms)
    rows = {}

    def band_in_turns(key, name, args, k):
        """ms of a band kernel (band_sweep_kernel<., k> or
        band_census_kernel<., k>) and of sweep_kernel at one shape, in turns
        (old, new, new, old): between CUDA events, and device time alone
        (the events also hold the wrapper's host time where a launch is
        shorter)."""
        old = lambda: sweep._sweep_cuda(*args, None, None)  # noqa: E731
        new = lambda: sweep._sweep_cuda(*args, None, k)     # noqa: E731
        turns = (old, new, new, old)
        ts = [_time_ms(f, reps=20) for f in turns]
        ds = [_device_ms(f) for f in turns]
        band, oldk = _band_name(args[8]), _old_kernel_name(args[8], args[10])
        print(f"[time] {key} {name} in turns ({oldk}, {band}, {band}, {oldk}): "
              + ", ".join(f"{t:.4f}" for t in ts)
              + " ms; device " + ", ".join("not measured" if t is None else f"{t:.4f}"
                                           for t in ds) + " ms")

        def median(xs):
            xs = [x for x in xs if x is not None]
            return statistics.median(xs) if xs else None

        return {"cost": args[8], "cw": args[10],
                "ms": median(ts[1:3]), "device_ms": median(ds[1:3]),
                "sweep_kernel_ms": median([ts[0], ts[3]]),
                "sweep_kernel_device_ms": median([ds[0], ds[3]])}

    for i, (key, c, cost, cw) in enumerate(sweep_mode_cases()):
        base, match, offs = _sweep_inputs(c, dev, 100 + i)
        args = (base, match, offs, c.get("tile", TILE), c["sx"], c["sy"], *c["kernel"],
                cost, bool(c["ring"]), cw)
        k = _band(c, cost, cw)
        turns = band_in_turns(key, c["name"], args, k) if k is not None else {}
        ms = turns.get("ms") or _time_ms(lambda: sweep.sweep(*args), reps=20)
        plain_ms = _time_ms(lambda: sweep.sweep_plain(*args), reps=3, warmup=1)
        rows[(key, c["name"])] = {**_row(ms, plain_ms, *_sweep_work(*args)), **turns}
    fl, fr = _frame_inputs(dev, 150)
    sx, sy = CALC3_SEARCH
    # the abs sweeps of config 3 (kernel 6's route) and kernel 7, in turns
    base, match, offs, t = sweep.frame_sweep_args(fl, fr, sx, sy, kw, kh, "abs")
    for name, args in (("config3", (base, match, offs, t, sx, sy, kw, kh, "abs", False, 5)),
                       ("config3_tiles", (*_k7_args(fl, fr, dev), False, 5))):
        k = sweep._sweep_variant("abs", args[3], args[4], args[5], kw, kh, 0)
        turns = band_in_turns("sweep", name, args, k)
        plain_ms = _time_ms(lambda: sweep.sweep_plain(*args), reps=3, warmup=1)
        rows[("sweep", name)] = {**_row(turns["ms"], plain_ms, *_sweep_work(*args)),
                                 **turns}
    for key, cost, cw in (("sweep_ncc", "ncc", 5), ("sweep_census_codes", "census", 7)):
        base, match, offs, t = sweep.frame_sweep_args(fl, fr, sx, sy, kw, kh, cost, cw)
        args = (base, match, offs, t, sx, sy, kw, kh, cost, False, cw)
        k = sweep._sweep_variant(cost, t, sx, sy, kw, kh, 0, cw, True)
        turns = band_in_turns(key, "config3", args, k) if k is not None else {}
        ms = turns.get("ms") or _time_ms(lambda: sweep.sweep(*args), reps=20)
        plain_ms = _time_ms(lambda: sweep.sweep_plain(*args), reps=3, warmup=1)
        rows[(key, "config3")] = {**_row(ms, plain_ms, *_sweep_work(*args)), **turns}
    from visionworkbench_torch.ops import cost_volume
    args = (fl, fr, sx, sy, kw, kh, "abs")
    ms = _time_ms(lambda: cost_volume.best_of_search(*args), reps=20)
    plain_ms = _time_ms(lambda: cost_volume.best_of_search_plain(*args), reps=3, warmup=1)
    npx = CALC3_OUT * CALC3_OUT
    rows[("best_of_search", "config3")] = _row(
        ms, plain_ms, 4 * (fl.numel() + fr.numel()) + npx * (8 + 1 + 4),
        npx * (SWEEP_OPS_BOX + SWEEP_OPS_SELECT) * sx * sy)
    args = _k7_args(fl, fr, dev)
    ms = _time_ms(lambda: cost_volume.tiled_search(*args), reps=20)
    plain_ms = _time_ms(lambda: cost_volume.tiled_search_plain(*args), reps=3, warmup=1)
    rows[("tiled_search", "config3_tiles")] = _row(ms, plain_ms, *_sweep_work(
        *args[:8], "abs", False))
    for i, c in enumerate(speckle_cases()):
        code = _speckle_input(c, dev, 200 + i)
        args = (code, c["hh"], c["hv"], c["t"], c["min_match"])
        ms = _time_ms(lambda: speckle.speckle_keep_mask(*args), reps=20)
        dev_ms = _device_ms(lambda: speckle.speckle_keep_mask(*args),
                            match=lambda k: "speckle" in k)
        plain_ms = _time_ms(lambda: speckle.speckle_keep_mask_plain(*args), reps=3, warmup=1)
        npx = c["h"] * c["w"]
        ops = npx * (2 * c["hh"] + 1) * (2 * c["hv"] + 1) * SPECKLE_OPS
        rows[("speckle", c["name"])] = {**_row(ms, plain_ms, 8 * npx, ops), "device_ms": dev_ms}
    from visionworkbench_torch.ops import _build, sgm_scan
    for i, c in enumerate(scan_cases()):
        inputs = _scan_inputs(c, dev, 300 + i)
        n = c["shape"][0]
        which, variant = _scan_pick(c)
        if variant is not None:
            # in turns with line_scan_kernel<0> / <1> at the same shape:
            # old, new, new, old (line_scan_kernel<1> at wide grids, 0.2-0.4
            # s a launch, 3 times)
            old = lambda: _line_scan_call(c, inputs)  # noqa: E731
            new = lambda: _scan_call(c, inputs)       # noqa: E731
            wide = c["shape"][-3] * c["shape"][-2] > _build.MGM_MAX_CELLS
            old_reps = (dict(reps=3, warmup=1) if which == "cluster_scan" and wide
                        else dict(reps=20))
            ts = [_time_ms(f, **(old_reps if f is old else dict(reps=20)))
                  for f in (old, new, new, old)]
            old_ms = statistics.median([ts[0], ts[3]])
            ms = statistics.median([ts[1], ts[2]])
            k = _old_kernel(c)
            print(f"[time] {c['kernel']} {c['name']} in turns ({k}, {which} {variant}, "
                  f"{which}, {k}): " + ", ".join(f"{t:.4f}" for t in ts) + " ms")
        else:
            ms, old_ms = _time_ms(lambda: _scan_call(c, inputs), reps=20), None
        plain_ms = _time_ms(lambda: _scan_call(c, inputs, plain=True), reps=3, warmup=1)
        r = _row(ms, plain_ms, *_scan_work(c))
        r["us_per_step"] = ms * 1e3 / n
        if old_ms is not None:
            r.update(line_scan_ms=old_ms, line_scan_us_per_step=old_ms * 1e3 / n)
        if which == "path_scan" and c["name"].startswith("calc"):
            # the path-line kernel at each number of lines a block, in turns
            # (8, 4, 2, 1, 1, 2, 4, 8)
            widths = [_build.PATH_SCAN_MAX_LINES >> i
                      for i in range(_build.PATH_SCAN_MAX_LINES.bit_length())]
            ts = {g: [] for g in widths}
            for g in widths + widths[::-1]:
                ts[g].append(_time_ms(lambda: sgm_scan._scan_bidir_cuda(
                    *inputs, c["shifts"], SGM_P1, SGM_P2, SGM_BAD, None, (variant[0], g)),
                    reps=10))
            r["lines_ms"] = {g: statistics.median(t) for g, t in ts.items()}
            print(f"[time] {c['kernel']} {c['name']} path_scan by lines a block (the "
                  f"wrapper's: {variant[1]}): " + ", ".join(
                      f"{g}: {t[0]:.4f} / {t[1]:.4f}" for g, t in ts.items()) + " ms")
        if which == "cluster_scan" and variant[0] == 1:
            # the register-carry kernel over a cluster at each number of
            # lanes a block, in turns (512, 256, 128, 64, 64, 128, 256, 512)
            nl = c["shape"][-1]
            widths = [512, 256, 128, 64]
            ts = {g: [] for g in widths}
            fn = getattr(sgm_scan, f"_{c['kernel']}_cuda")
            for g in widths + widths[::-1]:
                blocks = -(-nl // g)
                v = (1, 0, -(-nl // (32 * blocks)) * 32, blocks)
                ts[g].append(_time_ms(lambda: fn(*inputs, c["shifts"], SGM_P1, SGM_P2,
                                                 SGM_BAD, None, v), reps=10))
            r["lanes_ms"] = {g: statistics.median(t) for g, t in ts.items()}
            print(f"[time] {c['kernel']} {c['name']} cluster_scan by lanes a block (the "
                  f"wrapper's: {variant[2]} x {variant[3]} blocks): " + ", ".join(
                      f"{g}: {t[0]:.4f} / {t[1]:.4f}" for g, t in ts.items()) + " ms")
        rows[(c["kernel"], c["name"])] = r
    _time_wta(dev, rows)
    for (k, name), r in rows.items():
        extra = ""
        if "us_per_step" in r:
            extra = f", {r['us_per_step']:.4f} us per step"
        if "line_scan_ms" in r:
            extra += (f"; line_scan_kernel<{int(k != 'scan_bidir')}> "
                      f"{r['line_scan_ms']:.4f} ms, "
                      f"{r['line_scan_us_per_step']:.4f} us per step, "
                      f"{r['line_scan_ms'] / r['ms']:.2f}x")
        if "sweep_kernel_ms" in r:
            dev_new, dev_old = (("not measured" if r[x] is None else f"{r[x]:.4f} ms")
                                for x in ("device_ms", "sweep_kernel_device_ms"))
            extra += (f", device {dev_new} ({_band_name(r['cost'])}); "
                      f"{_old_kernel_name(r['cost'], r['cw'])} {r['sweep_kernel_ms']:.4f} ms, "
                      f"device {dev_old}")
        elif "device_ms" in r:
            extra += (", device " + ("not measured" if r["device_ms"] is None
                                     else f"{r['device_ms']:.4f} ms"))
        if k == "sgm_wta":
            extra += (f" (tie-rich costs, parabola); distinct costs {r['distinct_ms']:.4f} ms, "
                      f"mode none {r['none_ms']:.4f} ms")
        print(f"[time] {k} {name}: {r['ms']:.4f} ms per launch, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}){extra}")
    return frame, rows


def _time_wta(dev, rows):
    """sgm_wta at each of ``WTA_CASES``: the parabola on tie-rich costs
    (between events and as device time) against the plain version, the
    parabola on distinct costs and mode none; the bound is the bytes (the
    volume read once, 8 bytes a pixel written) over the card's bandwidth."""
    from visionworkbench_torch.ops import sgm_wta
    for i, (name, shape) in enumerate(WTA_CASES):
        vols = {ties: _wta_volume(shape, dev, 700 + 2 * i + ties, ties) for ties in (True, False)}

        def run(ties=True, mode="parabola"):
            return sgm_wta.volume_argmin_subpixel(vols[ties], mode, SGM_BAD)
        ms = _time_ms(run, reps=20)
        plain_ms = _time_ms(lambda: sgm_wta.volume_argmin_subpixel_plain(
            vols[True], "parabola", SGM_BAD), reps=3, warmup=1)
        r = _row(ms, plain_ms, 4 * vols[True].numel() + 8 * shape[0] * shape[1], 0)
        r["device_ms"] = _device_ms(run, match=lambda key: "sgm_wta" in key)
        r["distinct_ms"] = _time_ms(lambda: run(False), reps=20)
        r["none_ms"] = _time_ms(lambda: run(True, "none"), reps=20)
        rows[("sgm_wta", name)] = r
        del vols


def _time_cli(lt, rt, dev, frame):
    """The CLI frame (cli-log-1024) and its parabola variant: median ms over
    10 frames after 2 warm-ups, Mp/s, device time, idle share and launches;
    the LoG prefilter's device time and launches over the frame's 12
    pyramid levels (its share of the frame's device time); the blob
    filter's passes and ms on the frame's level-0 validity (card against
    CPU, the kept mask a subset)."""
    import torch
    from visionworkbench_torch.image import morphology
    from visionworkbench_torch.stereo.prefilter import prefilter_image
    for what, kw in (("cli_log", {}), ("cli_log_parabola", {"subpixel": "parabola"})):
        ms = _time_ms(lambda: _cli_run(lt, rt, dev, **kw), reps=10)
        frame[what] = {"ms": ms, "mps": H * W / (ms * 1e3)}
        print(f"[time] frame {what} (CLI defaults, {H}^2, kernel {CLI_KERNEL}, LoG "
              f"{CLI['prefilter_width']}, {CLI_LEVELS} levels): {ms:.4f} ms, "
              f"{frame[what]['mps']:.3f} Mp/s")
        busy, n = _profile_frame(lambda: _cli_run(lt, rt, dev, **kw), what, ms)
        frame[what].update(device_ms=busy, launches=n)
    # the prefilter alone, on the frame's pyramids (levels 5-0 of both images)
    from visionworkbench_torch.stereo.pyramid_correlation import _blur_downsample
    from visionworkbench_torch.image.edge import crop_extended
    # the base frames' sizes as pyramid_correlate pads them (CLI_LEVELS = the
    # level count at 1024^2, 21x21 and the 64x8 search)
    up = 1 << CLI_LEVELS
    pad = CLI_KERNEL[0] // 2 * up
    bw, bh = (n + 2 * pad + (-(n + 2 * pad)) % up + up for n in (W, H))
    pyr = []
    for img, (ew, eh) in ((lt, (0, 0)), (rt, SEARCH[2:])):
        fw, fh = bw + ew, bh + eh
        pyr.append(crop_extended(img, -pad, -pad, fw + (-fw) % up, fh + (-fh) % up))
        for _ in range(CLI_LEVELS):
            pyr.append(_blur_downsample(pyr[-1]))

    def prefilter_all():
        return [prefilter_image(p, "log", CLI["prefilter_width"]) for p in pyr]
    pre_ms = _time_ms(prefilter_all, reps=10)
    pre_dev, pre_n = _profile_frame(prefilter_all, "cli_log prefilter (12 levels)", pre_ms)
    busy = frame["cli_log"]["device_ms"]
    share = None if busy is None or pre_dev is None else pre_dev / busy
    print(f"[time] cli_log prefilter: {pre_ms:.4f} ms between events, device "
          f"{pre_dev} ms, {pre_n} launches, share of the frame's device time {share}")
    frame["cli_log"].update(prefilter_device_ms=pre_dev, prefilter_launches=pre_n,
                            prefilter_share=share)
    # the blob filter on the frame's level-0 validity
    mask = _cli_run(lt, rt, dev).valid
    labels, passes = morphology._blob_labels(mask)
    torch.cuda.synchronize()
    blob_ms = _time_ms(lambda: morphology.remove_small_blobs(mask, CLI_BLOB_AREA), reps=10)
    keep = morphology.remove_small_blobs(mask, CLI_BLOB_AREA)
    keep_cpu = morphology.remove_small_blobs(mask.cpu(), CLI_BLOB_AREA)
    n_blobs = int(torch.unique(labels[labels >= 0]).numel())
    print(f"[time] cli_log blob filter (area {CLI_BLOB_AREA}, 4-connected) on the level-0 "
          f"validity ({int(mask.sum())} valid, {n_blobs} blobs): {passes} passes, "
          f"{blob_ms:.4f} ms; keeps {int(keep.sum())}; card vs cpu differ at "
          f"{int((keep.cpu() != keep_cpu).sum())} pixels")
    if not torch.equal(keep.cpu(), keep_cpu) or bool((keep & ~mask).any()):
        raise SystemExit("cli_log blob filter: the kept mask differs card vs CPU or is "
                         "not a subset of the validity")
    frame["cli_log"].update(blob_passes=passes, blob_ms=blob_ms)
    # a harder mask for the label propagation: one serpentine blob of 512
    # one-pixel rows over 1024^2 (its passes grow with the rows)
    snake = torch.zeros((H, W), dtype=torch.bool)
    snake[0::2] = True
    snake[1::4, -1] = True
    snake[3::4, 0] = True
    snake = snake.to(dev)
    labels, passes = morphology._blob_labels(snake)
    snake_ms = _time_ms(lambda: morphology._blob_labels(snake), reps=3, warmup=1)
    same = torch.equal(labels.cpu(), morphology.blob_index(snake.cpu()))
    print(f"[time] blob_index on a {H}x{W} serpentine blob: {passes} passes, "
          f"{snake_ms:.4f} ms; labels card vs cpu equal: {same}")
    if not same or int(labels[snake].max()) != 0:
        raise SystemExit("blob_index: the serpentine blob's labels are wrong")
    frame["cli_log"].update(snake_passes=passes, snake_ms=snake_ms)


def _time_quality(lt, rt, dev, frame):
    """config7-em-1024 and its affine variant: median ms over 10 frames
    after 2 warm-ups, Mp/s, device time, idle share, launches and peak
    memory; the refiner alone on the frame's integer map (its ms, device
    time, launches and share of the frame's device time). cli-em-1024: the
    CLI's wall time (TIFF IO included; median of 3 runs after one), device
    time and launches of one run."""
    import torch
    c7l, c7r = (torch.as_tensor(a, device=dev) for a in _make_pair(H, W, CONFIG7_SEED))
    integer = _config7_run(c7l, c7r, dev, "none")
    for what, sp in (("config7_em", "em"), ("config7_affine", "affine")):
        ms = _time_ms(lambda: _config7_run(c7l, c7r, dev, sp), reps=10)
        torch.cuda.reset_peak_memory_stats()
        _config7_run(c7l, c7r, dev, sp)
        peak = torch.cuda.max_memory_allocated() / 2**20
        print(f"[time] frame {what} (config 7, {H}^2, census 5x5, 7x7, 4 levels, subpixel "
              f"{sp}): {ms:.4f} ms, {H * W / (ms * 1e3):.3f} Mp/s, peak memory {peak:.1f} MiB")
        busy, n = _profile_frame(lambda: _config7_run(c7l, c7r, dev, sp), what, ms)
        ref_ms = _time_ms(lambda: _config7_refiner(integer, c7l, c7r, sp), reps=5)
        ref_busy, ref_n = _profile_frame(lambda: _config7_refiner(integer, c7l, c7r, sp),
                                         f"{what} refiner", ref_ms, frames=1)
        share = None if busy is None or ref_busy is None else ref_busy / busy
        print(f"[time] {what} refiner alone: {ref_ms:.4f} ms, device {ref_busy} ms, "
              f"{ref_n} launches, share of the frame's device time {share}")
        frame[what] = {"ms": ms, "mps": H * W / (ms * 1e3), "device_ms": busy,
                       "launches": n, "peak_mib": peak, "refiner_ms": ref_ms,
                       "refiner_device_ms": ref_busy, "refiner_launches": ref_n,
                       "refiner_share": share}
    folder = tempfile.mkdtemp(prefix="chip_smoke_cli_em_")
    paths = _write_pair(lt.cpu().numpy(), rt.cpu().numpy(), folder)
    walls = [_cli_em_run(paths, dev, folder)[1] for _ in range(4)][1:]
    wall = statistics.median(walls)
    busy, n = _profile_frame(lambda: _cli_em_run(paths, dev, folder), "cli_em",
                             wall * 1e3, frames=1)
    shutil.rmtree(folder)
    print(f"[time] cli_em (the correlate CLI, {' '.join(CLI_EM_ARGS)}, {H}^2, TIFF IO "
          f"included): wall {', '.join(f'{t:.4f}' for t in walls)} s, median {wall:.4f} s, "
          f"{H * W / (wall * 1e6):.3f} Mp/s; device {busy} ms, {n} launches")
    frame["cli_em"] = {"ms": wall * 1e3, "mps": H * W / (wall * 1e6), "device_ms": busy,
                       "launches": n}


def _time_config5(dev, frame, n=H):
    """config5-mosaic-1024: the plan's host ms; the first frame on fresh
    plans (host clock, each source's mask, alpha and coordinates made),
    apart from the steady frame (median of 10 after 2 warm-ups, canvas Mp/s
    = n^2 / t as the config divides); device time, idle share and launches
    (profiler); peak memory."""
    import torch
    srcs, georefs, dst = _config5(n)
    srcs = [torch.as_tensor(s, device=dev) for s in srcs]
    t0 = time.perf_counter()
    plans = _config5_plans(georefs, dst, n)
    plan_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _config5_run(srcs, georefs, dst, plans, n, dev)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    ms = _time_ms(lambda: _config5_run(srcs, georefs, dst, plans, n, dev), reps=10)
    torch.cuda.reset_peak_memory_stats()
    _config5_run(srcs, georefs, dst, plans, n, dev)
    peak = torch.cuda.max_memory_allocated() / 2**20
    busy, launches = _profile_frame(lambda: _config5_run(srcs, georefs, dst, plans, n, dev),
                                    "config5", ms)
    print(f"[time] frame config5 (reproject + multiband mosaic, 4 sources of "
          f"{srcs[0].shape[0]}^2 into {n}^2, {C5_LEVELS} levels): {ms:.4f} ms, "
          f"{n * n / (ms * 1e3):.3f} canvas Mp/s, peak memory {peak:.1f} MiB; plan (host) "
          f"{plan_ms:.4f} ms; first frame on fresh plans {first_ms:.4f} ms")
    frame["config5"] = {"ms": ms, "mps": n * n / (ms * 1e3), "device_ms": busy,
                        "launches": launches, "peak_mib": peak, "plan_ms": plan_ms,
                        "first_ms": first_ms}


def _host_ops(run, what, top=10):
    """The host's self time per frame by PyTorch operator (torch.profiler,
    CPU activity), the largest first: where a host-bound frame spends its
    time between launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    print(f"[profile] {what} host self time by operator: " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}" for e in ops))


def _time_interest(dev, frame, n=H):
    """config1-1024 and config2-1024: median ms over 10 frames after 2
    warm-ups, Mp/s (n^2 / t for config 1; 2 n^2 / t for config 2, as the
    config divides), device time by kernel, idle share, launches and peak
    memory. cli-match-1024: each tool's wall time (TIFF IO included;
    median of 3 chains after one), and the chain's device time and
    launches (profiler, one chain)."""
    import torch
    img = torch.as_tensor(_texture(n, n, CONFIG7_SEED)[:, :n], device=dev)
    a, b = (torch.as_tensor(x, device=dev) for x in _config2_pair(n))
    for what, run, px in (("config1", lambda: _config1_run(img, dev), n * n),
                          ("config2", lambda: _config2_run(a, b, dev), 2 * n * n)):
        ms = _time_ms(run, reps=10)
        torch.cuda.reset_peak_memory_stats()
        run()
        peak = torch.cuda.max_memory_allocated() / 2**20
        busy, launches = _profile_frame(run, what, ms)
        _host_ops(run, what)
        print(f"[time] frame {what} ({n}^2): {ms:.4f} ms, {px / (ms * 1e3):.3f} Mp/s, "
              f"peak memory {peak:.1f} MiB")
        frame[what] = {"ms": ms, "mps": px / (ms * 1e3), "device_ms": busy,
                       "launches": launches, "peak_mib": peak}
    folder = tempfile.mkdtemp(prefix="chip_smoke_cli_match_")
    paths = _cli_match_files(n, dev, folder)
    _cli_match_chain(paths, dev, folder)
    walls = [{k: w for k, (_, w) in _cli_match_chain(paths, dev, folder)[0].items()}
             for _ in range(3)]
    med = {k: statistics.median(w[k] for w in walls) for k in walls[0]}
    chain_ms = sum(med.values()) * 1e3
    busy, launches = _profile_frame(lambda: _cli_match_chain(paths, dev, folder), "cli_match",
                                    chain_ms, frames=1)
    _host_ops(lambda: _cli_match_chain(paths, dev, folder), "cli_match", top=14)
    shutil.rmtree(folder)
    print(f"[time] cli_match (ipfind on both {n}^2 images, ipmatch, correlate --match-file; "
          f"TIFF IO included): median wall " + ", ".join(f"{k} {v:.4f} s" for k, v in med.items())
          + f"; chain {chain_ms / 1e3:.4f} s; device {busy} ms, {launches} launches")
    frame["cli_match"] = {**{f"{k}_s": v for k, v in med.items()}, "ms": chain_ms,
                          "device_ms": busy, "launches": launches}


def _time_sift(dev, frame, n=H):
    """config8-1024: median ms over 10 frames after 2 warm-ups, Mp/s (2 n^2
    / t, as the config divides), device time by kernel, idle share,
    launches, peak memory and host time by operator."""
    import torch
    a, b = (torch.as_tensor(x, device=dev) for x in _config2_pair(n))

    def run():
        return _config8_run(a, b, dev)
    ms = _time_ms(run, reps=10)
    torch.cuda.reset_peak_memory_stats()
    run()
    peak = torch.cuda.max_memory_allocated() / 2**20
    busy, launches = _profile_frame(run, "config8", ms)
    _host_ops(run, "config8", top=14)
    px = 2 * n * n
    print(f"[time] frame config8 ({n}^2): {ms:.4f} ms, {px / (ms * 1e3):.3f} Mp/s, "
          f"peak memory {peak:.1f} MiB")
    frame["config8"] = {"ms": ms, "mps": px / (ms * 1e3), "device_ms": busy,
                        "launches": launches, "peak_mib": peak}


def _sweep_work(base, match, offs, tile, sx, sy, kw, kh, cost, want_patches,
                census_window=5):
    """(bytes, operations) of one sweep: each input read once, each output
    written once; operations per pixel and candidate (ring included), per
    searched candidate for the best/worst update, plus the census codes of
    both frames or NCC's window energies."""
    import torch
    from visionworkbench_torch.image.census import census_positions, census_words
    ring = int(want_patches)
    npx = offs.shape[0] * offs.shape[1] * tile * tile
    n_int, n_ext = sx * sy, (sx + 2 * ring) * (sy + 2 * ring)
    nbytes = (base.numel() * base.element_size() + match.numel() * match.element_size()
              + 4 * offs.numel() + npx * (8 + 1 + 36 * ring))
    per = SWEEP_OPS_NCC if cost == "ncc" else SWEEP_OPS_BOX
    ops = 0
    if cost in ("census", "ternary_census"):
        ternary = cost == "ternary_census"
        per = sweep_ops_census(census_words(census_window, ternary))
        if base.dtype != torch.int32:   # codes from the frames' pixels
            ops += ((base.shape[0] * base.shape[1] + match.shape[0] * match.shape[1])
                    * len(census_positions(census_window, ternary))
                    * CENSUS_CODE_OPS * (2 if ternary else 1))
    if cost == "ncc":
        ops += NCC_ENERGY_OPS * (npx + match.numel())
    return nbytes, ops + npx * (per * n_ext + SWEEP_OPS_SELECT * n_int)


def _device_ms(fn, reps=10, tries=3, match=None):
    """Device time of one launch of ``fn`` (a call launching one kernel
    whose name ``match`` accepts; a sweep kernel by default): the mean over
    the launches the profiler recorded in ``reps`` calls. The profiler may
    miss launches, or a whole session: tried ``tries`` times, then None (not
    measured)."""
    match = match or _is_sweep
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and match(e.key)]
        n = sum(e.count for e in mine)
        if n:
            return sum(e.self_device_time_total for e in mine) / 1e3 / n
    return None


def _profile_frame(run, what, frame_ms, frames=3):
    """Device time per frame by kernel (torch.profiler, CUPTI) and the
    device's busy share of the frame time measured without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()    # device activities only
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print(f"[profile] {what}: the profiler saw no device time: busy share "
              "not measured")
        return None, None
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / frames
    n_kernels = sum(e.count for e in events) / frames
    print(f"[profile] {what}: device busy {busy_ms:.4f} ms per frame of "
          f"{frame_ms:.4f} ms (idle share {1 - busy_ms / frame_ms:.4f}), "
          f"{n_kernels:.1f} kernel launches of {len(events)} kinds per frame")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile] {what} {e.self_device_time_total / 1e3 / frames:9.4f} ms/frame "
              f"{e.count / frames:6.1f} calls/frame  {e.key[:90]}")
    kinds = {"sweep (all three kernels)": _is_sweep,
             "band_sweep_kernel": lambda k: "band_sweep_kernel" in k,
             "band_census_kernel": lambda k: "band_census_kernel" in k,
             "sweep_kernel": lambda k: "sweep_kernel" in k and "band_sweep" not in k,
             **{n: (lambda k, n=n: n in k)
                for n in ("speckle", "line_scan_kernel", "mgm_scan_kernel",
                          "path_scan_kernel", "cluster_wide_kernel")}}
    for name, match in kinds.items():
        mine = [e for e in events if match(e.key)]
        if mine:
            ms = sum(e.self_device_time_total for e in mine) / 1e3 / frames
            print(f"[profile] {what} by kernel: {name} {ms:.4f} ms/frame "
                  f"({ms / busy_ms:.4f} of device time), "
                  f"{sum(e.count for e in mine) / frames:.1f} calls/frame")
    # each sweep launch of the last frame, in launch order (a pyramid's
    # levels, coarsest first)
    launches = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                       and _is_sweep(e.name)), key=lambda e: e.time_range.start)
    per_frame = len(launches) // frames
    if per_frame:
        print(f"[profile] {what} sweep launches of a frame, in order: "
              + ", ".join(f"{e.time_range.elapsed_us() / 1e3:.4f}"
                          for e in launches[-per_frame:]) + " ms ("
              + ", ".join(_kernel_name(e.name) for e in launches[-per_frame:]) + ")")
    return busy_ms, n_kernels


# ---- phase 6: parallel/ on torch.distributed ----------------------------------

# A collective that waits longer than this fails the phase (every process
# group of the script is given it).
PAR_TIMEOUT_S = 60
# The hierarchical L<->R run (card against CPU): the bench settings at 512^2
# with a left mask, the L<->R check, the blob filter and the LoG prefilter.
PAR_MASKED_HW = 512
# The multi-card world: ranks (one a card), and each rank's wall limit.
PAR_MAX_RANKS = 4
PAR_RANK_TIMEOUT_S = 300


def _par_backend():
    """One group that takes CUDA tensors over NCCL and CPU tensors over
    gloo, where the build has NCCL."""
    import torch.distributed as dist
    return "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"


def _par_init(rank, world, init_file):
    from datetime import timedelta
    import torch.distributed as dist
    dist.init_process_group(_par_backend(), init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=PAR_TIMEOUT_S))


def _hier_run(left, right, mesh, **kw):
    """``hierarchical_sharded_correlate`` at the bench settings (parabola),
    ``kw`` adding or overriding options."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.parallel import hierarchical_sharded_correlate
    opts = dict(kernel_size=KERNEL, max_pyramid_levels=LEVELS, tile_size=TILE,
                subpixel="parabola")
    opts.update(kw)
    return hierarchical_sharded_correlate(left, right, BBox2i(*SEARCH), mesh, **opts)


def _hier_sgm_run(left, right, mesh, algo):
    """Hierarchical SGM / MGM at config 6's settings."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.parallel import hierarchical_sharded_correlate
    return hierarchical_sharded_correlate(
        left, right, BBox2i(*SGM_SEARCH), mesh, stereo_algorithm=algo,
        census_window=CENSUS_WINDOW, max_pyramid_levels=LEVELS, tile_size=TILE,
        subpixel="parabola")


def _core_agreement(ref, got, what, share=0.99, tol=1e-3, margin=16):
    """Of the ``margin``-px core's pixels valid in both maps, the share
    whose disparities agree within ``tol``; fails below ``share``
    (tests/test_parallel.py:153-185's claim)."""
    rd, rv = ref.to_numpy()
    gd, gv = got.to_numpy()
    core = np.s_[margin:-margin, margin:-margin]
    both = rv[core] & gv[core]
    agree = float((np.abs(rd[core] - gd[core]) <= tol).all(-1)[both].mean())
    print(f"[parallel] {what}: {agree:.6f} of the {margin}-px core valid in both agree "
          f"within {tol} px with the monolithic engine; validity equal on "
          f"{float((rv[core] == gv[core]).mean()):.6f}")
    if agree < share:
        raise SystemExit(f"{what}: agreement {agree:.4f} with the monolithic engine "
                         f"below {share}")


def _maps_equal(got, ref, what, atol=0.0):
    """Validity equal, disparities within ``atol`` (0: equal)."""
    cd, cv = got.to_numpy()
    pd, pv = ref.to_numpy()
    err = float(np.abs(cd - pd).max())
    print(f"[parallel] {what}: validity equal {bool((cv == pv).all())} "
          f"(valid {cv.mean():.4f}), max |d| {err}")
    if not (cv == pv).all() or err > atol:
        raise SystemExit(f"{what}: the maps differ")


def _launched(counts, what, *keys):
    """Fails unless each counter in ``keys`` counted a launch."""
    missing = [k for k in keys if not counts[k]]
    if missing:
        raise SystemExit(f"{what}: no launch counted on {missing}: {counts}")


def _par_time(what, run, px, frame, smi):
    """One frame of ``run``: its launches by kernel (the counts set to 0 just
    before it, read just after); then the median of 5 frames after 2
    warm-ups, Mp/s (``px`` / t), device time and idle share (profiler),
    peak memory."""
    import torch
    _reset_counts()
    run()
    torch.cuda.synchronize()
    counts = {k: v for k, v in _read_counts().items() if v}
    ms = _time_ms(run, reps=5)
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    busy, n = _profile_frame(run, f"parallel {what}", ms)
    idle = None if busy is None else 1 - busy / ms
    print(f"[parallel] frame {what}: {ms:.4f} ms, {px / (ms * 1e3):.3f} Mp/s, device "
          f"{busy} ms, idle share {idle}, {n} launches, by kernel {counts}, peak memory "
          f"{peak:.1f} MiB; card {smi}")
    frame[what] = {"ms": ms, "mps": px / (ms * 1e3), "device_ms": busy, "idle": idle,
                   "launches": n, "peak_mib": peak}


def _par_children(world, folder):
    """The multi-card world: ``world`` ranks of this script (one a card,
    NCCL), each running the hierarchical bench frame; rank 0's map and
    median frame ms come back in ``folder``."""
    import os
    init = os.path.join(folder, "children_rendezvous")
    out = os.path.join(folder, "rank0.npz")
    procs = [subprocess.Popen([sys.executable, __file__, "--parallel-rank", str(r), str(world),
                               init, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=PAR_RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise SystemExit(f"parallel: the {world}-card world passed its "
                             f"{PAR_RANK_TIMEOUT_S} s limit")
    for r, (p, o) in enumerate(zip(procs, outs)):
        print(o.strip())
        if p.returncode != 0:
            raise SystemExit(f"parallel: rank {r} of the {world}-card world failed")
    return dict(np.load(out))


def _parallel_rank(rank, world, init_file, out_file):
    """``chip_smoke.py --parallel-rank <rank> <world> <init_file> <out>``:
    one rank of the multi-card world (card ``rank``)."""
    import torch
    import torch.distributed as dist
    from visionworkbench_torch.parallel import make_tile_mesh
    rank, world = int(rank), int(world)
    torch.cuda.set_device(rank)
    _par_init(rank, world, init_file)
    mesh = make_tile_mesh()
    left, right = (torch.as_tensor(a, device="cuda") for a in _make_pair(H, W))
    dm = _hier_run(left, right, mesh)
    ms = _time_ms(lambda: _hier_run(left, right, mesh), reps=5)
    print(f"[parallel] rank {rank} of {world} on card {torch.cuda.current_device()}: "
          f"hierarchical bench frame {ms:.4f} ms")
    if rank == 0:
        d, v = dm.to_numpy()
        np.savez(out_file, disparity=d, valid=v, ms=ms)
    _par_breakdown(rank, world, mesh, lambda: _hier_run(left, right, mesh), ms)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _par_breakdown(rank, world, mesh, run, frame_ms, reps=50):
    """Where a multi-card frame's time goes (rank 0 prints): the host
    clock of one halo exchange of a level-0 band (7 rows a side), of one
    all-gather of a 16-row band and of one halo deeper than that band (the
    coarse levels' all-gather path), each the mean of ``reps`` after a
    barrier; then the profiler over 3 frames: device busy time, the host's
    self time by operator and the device time by kernel."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from visionworkbench_torch.parallel import TILE_AXIS, halo_exchange_rows
    from visionworkbench_torch.parallel.mesh import axis_group
    from visionworkbench_torch.parallel.tile_sharding import all_gather_rows
    group, n, _ = axis_group(mesh, TILE_AXIS)
    band = torch.rand((H // world, W + 160), device="cuda")
    small = torch.rand((16, 80), device="cuda")

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    halo_ms = per_call(lambda: halo_exchange_rows(band, 7, 7, mesh))
    gather_ms = per_call(lambda: all_gather_rows(small, group, n))
    deep_ms = per_call(lambda: halo_exchange_rows(small, 7, 55, mesh))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if rank:
        return
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / 3
    print(f"[parallel] breakdown, rank 0 of {world}: frame {frame_ms:.4f} ms, device busy "
          f"{busy:.4f} ms (profiled); one halo exchange of a {tuple(band.shape)} band "
          f"(7 rows a side) {halo_ms:.4f} ms, one all-gather of a {tuple(small.shape)} band "
          f"{gather_ms:.4f} ms, one deep halo (7, 55) of it {deep_ms:.4f} ms (host clock)")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:14]:
        print(f"[parallel] breakdown host {e.self_cpu_time_total / 1e3 / 3:9.4f} ms/frame "
              f"x{e.count / 3:6.1f}  {e.key[:70]}")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[parallel] breakdown device {e.self_device_time_total / 1e3 / 3:9.4f} ms/frame "
              f"x{e.count / 3:6.1f}  {e.key[:70]}")


def phase_parallel(dev, smi):
    """``parallel/`` in a world of one rank on the card (``_par_backend``,
    a ``file://`` rendezvous): hierarchical BM on the bench pair (against
    the monolithic engine on the card), with a mask, the L<->R check, the
    blob filter and the LoG prefilter at 512^2 (card against CPU, subpixel
    none), hierarchical SGM and MGM at config 6 (card against CPU),
    ``sharded_pyramid_correlate`` on the bench pair, ``disparity_sharded_
    search`` at 1024^2 (against ``best_of_search_convolution``) and
    ``reproject_mosaic(mesh=...)`` on config 5 (against ``mesh=None``);
    each frame timed. With two cards or more, a world of up to four NCCL
    ranks runs the bench frame too. Returns ``(launches by run, frames)``."""
    import os
    import torch
    import torch.distributed as dist
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.parallel import (
        disparity_sharded_search, make_disp_mesh, make_tile_mesh,
        sharded_pyramid_correlate,
    )
    from visionworkbench_torch.stereo.correlation import DisparityMap, best_of_search_convolution
    folder = tempfile.mkdtemp(prefix="vw_parallel_")
    torch.cuda.set_device(0)
    _par_init(0, 1, os.path.join(folder, "rendezvous"))
    print(f"[parallel] world of 1 rank, backend {_par_backend()}, card {smi}")
    mesh, cpu_mesh = make_tile_mesh(), make_tile_mesh(device="cpu")
    counts, frame = {}, {}

    def counted(name, run):
        _reset_counts()
        out = run()
        _sync(dev)
        counts[name] = _read_counts()
        return out

    left, right = (torch.as_tensor(a, device=dev) for a in _make_pair(H, W))
    # 1. hierarchical BM with the parabola, against the monolithic engine
    dm = counted("hier_bm", lambda: _hier_run(left, right, mesh))
    _launched(counts["hier_bm"], "parallel hier_bm", "sweep/band", "speckle")
    _sanity(dm, "parallel hier_bm")
    whole = _bench_run(left, right, dev)
    _core_agreement(whole, dm, "hier_bm")
    # 2. a mask, L<->R, the blob filter and LoG at 512^2: card = CPU
    n = PAR_MASKED_HW
    ml, mr = _make_pair(n, n)
    mask = np.ones((n, n), bool)
    mask[n // 3:n // 3 + 64, n // 4:n // 4 + 96] = False       # a hole across bands
    masked = dict(left_mask=mask, consistency_threshold=2.0, blob_filter_area=CLI_BLOB_AREA,
                  prefilter_mode="log", prefilter_width=1.4, subpixel="none")
    card = counted("hier_masked", lambda: _hier_run(ml, mr, mesh, **masked))
    _launched(counts["hier_masked"], "parallel hier_masked", "sweep/band", "speckle")
    _maps_equal(card, _hier_run(ml, mr, cpu_mesh, **masked), f"hier_masked {n}^2, card vs CPU")
    # 3. SGM and MGM at config 6: card = CPU
    sl, sr = _make_pair(SGM_HW, SGM_HW)
    for algo, keys in (("sgm", ("scan_bidir", "sgm_wta")),
                       ("mgm", ("mgm_bidir", "mgm_fwd", "sgm_wta"))):
        card = counted(f"hier_{algo}", lambda: _hier_sgm_run(sl, sr, mesh, algo))
        _launched(counts[f"hier_{algo}"], f"parallel hier_{algo}", "speckle", *keys)
        _maps_equal(card, _hier_sgm_run(sl, sr, cpu_mesh, algo),
                    f"hier_{algo} {SGM_HW}^2, card vs CPU", atol=2e-5)
    # 4. the collar-halo correlator on the bench pair
    spc = counted("sharded_pyramid", lambda: sharded_pyramid_correlate(
        left, right, BBox2i(*SEARCH), mesh, kernel_size=KERNEL, max_pyramid_levels=LEVELS,
        tile_size=TILE, subpixel="parabola"))
    _launched(counts["sharded_pyramid"], "parallel sharded_pyramid", "sweep/band", "speckle")
    _sanity(spc, "parallel sharded_pyramid")
    # 5. the disparity-sharded search: equal to best_of_search_convolution
    sx, sy = CALC_SEARCH
    dl, dr = (torch.as_tensor(a, device=dev) for a in _make_calc_pair(H, W))
    disp_mesh = make_disp_mesh()
    ds = counted("disp_search", lambda: disparity_sharded_search(dl, dr, (sx, sy), KERNEL,
                                                                 disp_mesh))
    _launched(counts["disp_search"], "parallel disp_search", "sweep/band")
    _maps_equal(ds, best_of_search_convolution(dl, dr, (sx, sy), KERNEL, device=dev),
                "disparity_sharded_search vs best_of_search_convolution")
    # 6. config 5 with a mesh: equal to mesh=None
    from visionworkbench_torch.mosaic.geomosaic import reproject_mosaic
    srcs, georefs, dst = _config5(H)
    srcs = [torch.as_tensor(a, device=dev) for a in srcs]
    plans = _config5_plans(georefs, dst, H)

    def mosaic(m):
        return reproject_mosaic(srcs, georefs, dst, (H, W), levels=C5_LEVELS, plans=plans,
                                mesh=m)
    got, want = counted("mosaic", lambda: mosaic(mesh)), mosaic(None)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit("reproject_mosaic(mesh=...) differs from mesh=None")
    print("[parallel] config5 reproject_mosaic(mesh=...) equals mesh=None bit for bit")

    for what, run, px in (
            ("hier_bm", lambda: _hier_run(left, right, mesh), H * W),
            ("hier_sgm", lambda: _hier_sgm_run(sl, sr, mesh, "sgm"), SGM_HW ** 2),
            ("hier_mgm", lambda: _hier_sgm_run(sl, sr, mesh, "mgm"), SGM_HW ** 2),
            ("sharded_pyramid", lambda: sharded_pyramid_correlate(
                left, right, BBox2i(*SEARCH), mesh, kernel_size=KERNEL,
                max_pyramid_levels=LEVELS, tile_size=TILE, subpixel="parabola"), H * W),
            ("disp_search", lambda: disparity_sharded_search(dl, dr, (sx, sy), KERNEL,
                                                             disp_mesh), H * W),
            ("mosaic", lambda: mosaic(mesh), H * W)):
        _par_time(what, run, px, frame, smi)

    cards = torch.cuda.device_count()
    if cards >= 2:
        world = min(cards, PAR_MAX_RANKS)
        r = _par_children(world, folder)
        multi = DisparityMap.from_numpy(r["disparity"], r["valid"], dev)
        _sanity(multi, f"parallel hier_bm on {world} cards")
        _core_agreement(whole, multi, f"hier_bm on {world} cards")
        print(f"[parallel] world of {world} cards ({_par_backend()}): hierarchical bench "
              f"frame {float(r['ms']):.4f} ms on rank 0")
        frame["multi_card"] = {"world": world, "ms": float(r["ms"])}
    else:
        print(f"[parallel] multi-card world not run: {cards} card (it needs a second card)")
    dist.destroy_process_group()
    shutil.rmtree(folder, ignore_errors=True)
    return counts, frame


# ---- phase 7: host IO and tile pyramids -----------------------------------------

# host-io-8192: an 8192^2 float32 texture (256 MiB) written tile by tile at
# tile 256 (1024 tiles) by 4 threads; each card tile read with a 2-px margin
# (the 5-tap pyramid kernel's reach).
HOST_IO_N = 8192
HOST_IO_TILE = 256
HOST_IO_THREADS = 4
HOST_IO_MARGIN = 2
HOST_IO_SEED = 19
HOST_IO_NODATA = -9999.0
# pyramid-8192: levels down to 64 px (8 levels: 8192 ... 64), and the scales
# get_image_clip is asked for with the level each must serve.
PYR_MIN_DIM = 64
PYR_CLIPS = ((1.0, 0), (0.5, 1), (0.25, 2), (1 / 128, 7))
# image2qtree-config5: config 5's sources as GeoTIFFs, card against CPU at
# 1024, the card alone at 2048 (four 1228^2 sources).
QTREE_NS = (1024, 2048)
QTREE_TILE = 256
QTREE_BLENDS = ("multiband", "draft")
QTREE_SHARE = 0.999


def _host_texture(n, seed, dev):
    """``_texture``'s formula at n^2, made on ``dev`` from ``seed`` (the
    noise drawn by a torch generator there)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    ys = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
    return (torch.sin(xs * 0.21) * torch.cos(ys * 0.17)
            + 0.5 * torch.sin(xs * 0.047 + ys * 0.031)
            + 0.3 * torch.rand((n, n), generator=g, device=dev))


def _blur_tile_fn(view, n, dev):
    """``tile_fn`` of the card-work writes: the tile and a margin read from
    ``view`` (clipped to the frame), blurred on ``dev`` with the pyramid
    kernel (zero edge), cropped back to the tile and copied to the host."""
    import torch
    from visionworkbench_torch.image.convolution import separable_convolution_filter
    from visionworkbench_torch.image.filters import generate_pyramid_smoothing_kernel
    from visionworkbench_torch.math.bbox import BBox2i
    k = generate_pyramid_smoothing_kernel()
    m = HOST_IO_MARGIN

    def tile_fn(b):
        x0, y0 = max(b.min_x - m, 0), max(b.min_y - m, 0)
        x1, y1 = min(b.max_x + m, n), min(b.max_y + m, n)
        region = torch.as_tensor(view.read_region(BBox2i(x0, y0, x1 - x0, y1 - y0)),
                                 device=dev)
        out = separable_convolution_filter(region, k, k, edge="constant")
        return out[b.min_y - y0:b.max_y - y0, b.min_x - x0:b.max_x - x0].cpu().numpy()
    return tile_fn


def _write(what, path, n, tile_fn, out, **kw):
    """One ``block_write_image`` of an n^2 float32 frame: wall and MB/s."""
    from visionworkbench_torch.fileio import block_write_image
    t0 = time.perf_counter()
    block_write_image(path, n, n, 1, np.float32, tile_fn, tile_size=HOST_IO_TILE,
                      num_threads=HOST_IO_THREADS, **kw)
    wall = time.perf_counter() - t0
    mbs = n * n * 4 / 2**20 / wall
    print(f"[host-io] {what}: {n}^2 float32 in {(n // HOST_IO_TILE) ** 2} tiles of "
          f"{HOST_IO_TILE}, {HOST_IO_THREADS} threads: {wall:.4f} s, {mbs:.1f} MiB/s")
    out[f"host_io_{what}_s"] = wall
    out[f"host_io_{what}_mibs"] = mbs


def _read_back(what, path, want, out, atol=0.0):
    from visionworkbench_torch.fileio import read_tiff
    t0 = time.perf_counter()
    got, info = read_tiff(path)
    out[f"host_io_{what}_read_s"] = time.perf_counter() - t0
    err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    print(f"[host-io] {what} read back in {out[f'host_io_{what}_read_s']:.4f} s: "
          f"max |file - expected| {err}")
    if err > atol:
        raise SystemExit(f"host-io {what}: the file differs from the expected frame "
                         f"(max |d| {err} > {atol}, shape {got.shape})")
    out[f"host_io_{what}_max_abs_err"] = err
    return info


def _partial(path, n, full, fail_tile, **kw):
    """A write whose ``tile_fn`` raises at ``fail_tile``: the error must
    reach the caller, and the resume set must name exactly the tiles on
    disk (each read back equal to the frame; no other tile has data)."""
    from visionworkbench_torch.fileio import block_write_image
    from visionworkbench_torch.fileio.tiff import T_TILE_OFFSETS, TiffInfo, read_tiff_region
    from visionworkbench_torch.fileio.tiled_writer import resume_completed_tiles
    ts = HOST_IO_TILE

    def tile_fn(b):
        if (b.min_x // ts, b.min_y // ts) == fail_tile:
            raise RuntimeError("host-io partial write: tile failed on purpose")
        return full[b.min_y:b.max_y, b.min_x:b.max_x]
    try:
        block_write_image(path, n, n, 1, np.float32, tile_fn, tile_size=ts,
                          num_threads=HOST_IO_THREADS, **kw)
    except RuntimeError as e:
        if "on purpose" not in str(e):
            raise
    else:
        raise SystemExit("host-io partial write: the tile function's error was lost")
    done = resume_completed_tiles(path, ts)
    ntx = n // ts
    if kw:      # the Python route writes its IFD: a raster prefix is on disk
        offsets = TiffInfo(path)._get(T_TILE_OFFSETS, [])
        on_disk = {(i % ntx, i // ntx) for i, off in enumerate(offsets) if off}
        prefix = {(i % ntx, i // ntx) for i in range(len(done))}
        bad = [t for t in done if not np.array_equal(
            read_tiff_region(path, t[0] * ts, t[1] * ts, ts, ts),
            full[t[1] * ts:(t[1] + 1) * ts, t[0] * ts:(t[0] + 1) * ts])]
        first = fail_tile[1] * ntx + fail_tile[0]
        if done != on_disk or done != prefix or len(done) > first or bad:
            raise SystemExit(f"host-io resume: {len(done)} tiles named, {len(on_disk)} on "
                             f"disk, raster prefix {done == prefix}, tiles that differ {bad}")
    elif done:  # the native route writes no IFD after a failure
        raise SystemExit(f"host-io resume: {len(done)} tiles named in a failed native write")
    return len(done)


def _host_io(dev, n, folder, out):
    """host-io-8192's writes and checks; returns the texture file's path."""
    from visionworkbench_torch.cartography import (
        georeference_from_tiff_info, make_geographic_georef,
    )
    from visionworkbench_torch.fileio import DiskImageView
    from visionworkbench_torch.image.convolution import separable_convolution_filter
    from visionworkbench_torch.image.filters import generate_pyramid_smoothing_kernel
    tex_dev = _host_texture(n, HOST_IO_SEED, dev)
    tex = tex_dev.cpu().numpy()
    src = os.path.join(folder, "texture.tif")
    _write("native", src, n, lambda b: tex[b.min_y:b.max_y, b.min_x:b.max_x], out)
    _read_back("native", src, tex, out)
    k = generate_pyramid_smoothing_kernel()
    whole = separable_convolution_filter(tex_dev, k, k, edge="constant").cpu().numpy()
    del tex_dev
    view = DiskImageView(src, tile_size=HOST_IO_TILE)
    blur = os.path.join(folder, "blur.tif")
    _tile_work(view, n, dev, out)
    _write("card_native", blur, n, _blur_tile_fn(view, n, dev), out)
    _read_back("card_native", blur, whole, out, atol=1e-6)
    georef = make_geographic_georef(-120.0, 40.0, 1e-4)
    geo = os.path.join(folder, "blur_geo.tif")
    _write("card_python", geo, n, _blur_tile_fn(view, n, dev), out, georef=georef,
           nodata=HOST_IO_NODATA)
    info = _read_back("card_python", geo, whole, out, atol=1e-6)
    back = georeference_from_tiff_info(info)
    if (back is None or not np.array_equal(back.transform, georef.transform)
            or info.nodata != HOST_IO_NODATA):
        raise SystemExit(f"host-io card_python: georef or nodata not read back "
                         f"({None if back is None else back.transform}, {info.nodata})")
    fail = (n // HOST_IO_TILE // 3, n // HOST_IO_TILE // 2)
    out["host_io_resume_tiles"] = _partial(os.path.join(folder, "partial.tif"), n, tex,
                                           fail, nodata=HOST_IO_NODATA)
    _partial(os.path.join(folder, "partial_native.tif"), n, tex, fail)
    print(f"[host-io] partial writes (tile {fail} raises): the error reached the caller on "
          f"both routes; resume names the {out['host_io_resume_tiles']} tiles on disk "
          "(Python route) and none after the failed native write")
    return src, tex


def _pyramid(dev, src, n, folder, out):
    """pyramid-8192: the levels on the card against the CPU's, the clips,
    and the build's wall and device time."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.mosaic import DiskImagePyramid

    def build(d, tag):
        return DiskImagePyramid(src, min_dimension=PYR_MIN_DIM, tile_size=HOST_IO_TILE,
                                cache_dir=os.path.join(folder, f"pyr_{tag}"), device=d)
    _sync(dev)
    t0 = time.perf_counter()
    card = build(dev, "card")
    _sync(dev)
    out["host_io_pyramid_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = build("cpu", "cpu")
    out["host_io_pyramid_cpu_s"] = time.perf_counter() - t0
    want_levels = 1 + int(np.log2(n // PYR_MIN_DIM))
    if card.num_levels != want_levels or cpu.num_levels != want_levels:
        raise SystemExit(f"pyramid: {card.num_levels} levels on the card, {cpu.num_levels} "
                         f"on the CPU, {want_levels} expected")
    errs = []
    for a, b in zip(card.levels, cpu.levels):
        ga, gb = a.read(), b.read()
        errs.append(float(np.abs(ga - gb).max()) if ga.shape == gb.shape else float("inf"))
    print(f"[pyramid] {n}^2 -> {card.levels[-1].rows}^2, {card.num_levels} levels; max "
          f"|card - CPU| per level {errs}")
    if max(errs) > 1e-6:
        raise SystemExit(f"pyramid: card and CPU levels differ by {max(errs)}")
    region = BBox2i(n // 8, n // 4, n // 2, n // 4)
    for scale, level in PYR_CLIPS:
        level = min(level, want_levels - 1)     # a smaller rehearsal frame
        clip, got = card.get_image_clip(scale, region)
        f = 1 << level
        shape = (max(region.height // f, 1), max(region.width // f, 1))
        ref, _ = cpu.get_image_clip(scale, region)
        if got != level or clip.shape != shape or float(np.abs(clip - ref).max()) > 1e-6:
            raise SystemExit(f"pyramid clip at scale {scale}: level {got}, shape "
                             f"{clip.shape}; {level} and {shape} expected")
    print(f"[pyramid] get_image_clip at scales {[s for s, _ in PYR_CLIPS]}: levels "
          f"{[lv for _, lv in PYR_CLIPS]}, shapes as expected")
    kernel_ms, copy_ms = _device_split(dev, lambda: build(dev, "card_profiled"))
    out["host_io_pyramid_kernel_ms"] = kernel_ms
    out["host_io_pyramid_copy_ms"] = copy_ms
    out["host_io_pyramid_max_abs_err"] = max(errs)
    print(f"[pyramid] build: {out['host_io_pyramid_s']:.4f} s on the card (device time of a "
          f"profiled build: kernels {kernel_ms} ms, copies {copy_ms} ms), "
          f"{out['host_io_pyramid_cpu_s']:.4f} s on the CPU")


def _device_split(dev, run):
    """Device time of ``run`` (torch.profiler, CUDA activity): kernels and
    memory copies apart, in ms; (None, None) off the card or when the
    profiler saw nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if torch.device(dev).type != "cuda":
        return None, None
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copy = sum(e.self_device_time_total for e in events if "Memcpy" in e.key) / 1e3
    kernel = sum(e.self_device_time_total for e in events if "Memcpy" not in e.key) / 1e3
    return (kernel, copy) if events else (None, None)


def _tile_work(view, n, dev, out, sample=128):
    """The card work of one tile function alone, without the writer: every
    tile in turn on one thread (wall), and the device time of the first
    ``sample`` tiles (kernels and copies, per tile)."""
    from visionworkbench_torch.math.bbox import BBox2i, subdivide_bbox
    tile_fn = _blur_tile_fn(view, n, dev)
    tiles = subdivide_bbox(BBox2i(0, 0, n, n), HOST_IO_TILE, HOST_IO_TILE)
    sample = min(sample, len(tiles))
    t0 = time.perf_counter()
    for b in tiles:
        tile_fn(b)
    wall = time.perf_counter() - t0
    kernel_ms, copy_ms = _device_split(dev, lambda: [tile_fn(b) for b in tiles[:sample]])
    per = (lambda ms: None if ms is None else ms / sample)
    out["host_io_tile_fn_serial_s"] = wall
    out["host_io_tile_fn_kernel_ms"] = per(kernel_ms)
    out["host_io_tile_fn_copy_ms"] = per(copy_ms)
    print(f"[host-io] the card tile function alone, {len(tiles)} tiles on one thread: "
          f"{wall:.4f} s ({wall / len(tiles) * 1e3:.4f} ms a tile); device time a tile "
          f"(first {sample}, profiled): kernels {per(kernel_ms)} ms, copies {per(copy_ms)} ms")


def _qtree_sources(n, folder):
    from visionworkbench_torch.fileio import write_tiff
    srcs, georefs, _ = _config5(n)
    paths = []
    for i, (s, g) in enumerate(zip(srcs, georefs)):
        paths.append(os.path.join(folder, f"c5_{n}_{i}.tif"))
        write_tiff(paths[-1], s, georef=g)
    return paths


def _qtree_run(paths, folder, blend, dev, tag):
    """image2qtree's CLI: wall, tile list, KML text and the tiles' folder."""
    import contextlib
    import io
    import glob
    from visionworkbench_torch.tools.image2qtree import main
    name = os.path.join(folder, tag, "qt")
    os.makedirs(os.path.dirname(name), exist_ok=True)
    buf = io.StringIO()
    _sync(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(paths + ["-o", name, "--tile-size", str(QTREE_TILE), "--blend", blend],
                  device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"image2qtree {tag}: exit {rc}")
    tiles = sorted(os.path.relpath(p, name) for p in glob.glob(os.path.join(name, "*", "*",
                                                                             "*.png")))
    with open(name + ".kml") as f:
        kml = f.read()
    return wall, tiles, kml, name, buf.getvalue()


def _image2qtree(dev, folder, out):
    """image2qtree-config5 at 1024 (card against CPU) and 2048 (card)."""
    from visionworkbench_torch.fileio import read_image
    small, big = QTREE_NS
    paths = _qtree_sources(small, folder)
    for blend in QTREE_BLENDS:
        cw, ct, ck, cn, _ = _qtree_run(paths, folder, blend, dev, f"card_{small}_{blend}")
        hw, ht, hk, hn, _ = _qtree_run(paths, folder, blend, "cpu", f"cpu_{small}_{blend}")
        if ct != ht or ck != hk:
            raise SystemExit(f"image2qtree {blend} {small}: tiles ({len(ct)} vs {len(ht)}) or "
                             "KML differ card against CPU")
        flips = total = worst = 0
        for rel in ct:
            a = read_image(os.path.join(cn, rel)).astype(np.int16)
            b = read_image(os.path.join(hn, rel)).astype(np.int16)
            d = np.abs(a - b)
            worst = max(worst, int(d.max()))
            flips += int((d > 0).sum())
            total += d.size
        share = 1 - flips / total
        print(f"[image2qtree] config5 {small} {blend}: {len(ct)} tiles, KML equal; card "
              f"against CPU: max {worst} LSB, equal on {share:.6f} of {total} pixels; wall "
              f"{cw:.4f} s on the card, {hw:.4f} s on the CPU")
        if worst > 1 or share < QTREE_SHARE:
            raise SystemExit(f"image2qtree {blend} {small}: card against CPU max {worst} LSB, "
                             f"equal share {share}")
        out[f"host_io_qtree_{small}_{blend}_s"] = cw
        out[f"host_io_qtree_{small}_{blend}_cpu_s"] = hw
        out[f"host_io_qtree_{small}_{blend}_tiles"] = len(ct)
    paths = _qtree_sources(big, folder)
    for blend in QTREE_BLENDS:
        cw, ct, _, _, printed = _qtree_run(paths, folder, blend, dev, f"card_{big}_{blend}")
        print(f"[image2qtree] config5 {big} (4 sources of {int(big * 0.6)}^2) {blend}: "
              f"{len(ct)} tiles in {cw:.4f} s on the card ({printed.splitlines()[0]})")
        out[f"host_io_qtree_{big}_{blend}_s"] = cw
        out[f"host_io_qtree_{big}_{blend}_tiles"] = len(ct)


def phase_host_io(dev, n=HOST_IO_N):
    """host-io-8192, pyramid-8192 and image2qtree-config5 (see the module
    docstring, phase 7); no kernel of csrc/ may launch on the pyramid and
    image2qtree runs. Returns the ``host_io_*`` numbers."""
    import torch
    from visionworkbench_torch import native
    out = {}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fresh = not native.library_path().exists()
    native.load()
    out["host_io_native_build_s"] = time.perf_counter() - t0
    print(f"[host-io] native runtime {'built' if fresh else 'loaded (built before)'} with "
          f"g++ in {out['host_io_native_build_s']:.4f} s: {native.library_path()}")
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    folder = tempfile.mkdtemp(prefix="chip_smoke_host_io_")
    try:
        src, _ = _host_io(dev, n, folder, out)
        if cuda:
            out["host_io_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
            print(f"[host-io] peak device memory {out['host_io_peak_mib']:.1f} MiB")
        _reset_counts()
        _pyramid(dev, src, n, folder, out)
        _image2qtree(dev, folder, out)
        _sync(dev)
        counts = _read_counts()
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"[host-io] launches over the pyramid and image2qtree runs: {counts}")
    if any(counts.values()):
        raise SystemExit(f"host-io: a kernel of csrc/ ran on the pyramid or image2qtree: {counts}")
    out["host_io_phase_s"] = time.perf_counter() - t_phase
    print(f"[host-io] phase wall {out['host_io_phase_s']:.4f} s")
    return out


# ---- phase 8: cameras, triangulation and DEMs ------------------------------------

# stereo-dem-1024: the scene (the cameras, the true DEM, the texture) and its
# float64 oracle are in stereo_dem_scene.py, which the CPU tests share.
DEM_REPS = 5
DEM_MARGIN = 16              # the correlator gate's core
DEM_SHARE = 0.9
DEM_CORR_PX = 0.5            # correlated disparity against the true one
# round trips pixel -> ray -> point -> pixel (px) and ray -> pixel -> ray
# (tests/test_camera.py:42, :90, :177); each model's point distance
DEM_RT = {"tsai": (1e-2, 1e-4, 1000.0), "cahvor": (1e-2, 1e-4, 50.0),
          "cahvore_1": (5e-2, 1e-4, 40.0), "cahvore_0.5": (5e-2, 1e-4, 40.0),
          "cahvore_0": (5e-2, 1e-4, 40.0)}

# card against CPU: every step of the chain, the tools and the pieces of the
# orthoprojection give equal results on both devices (single multiplies and
# adds, IEEE quotients, correctly rounded roots, float64 geodetic in the DEM
# step), except the fp32 sin/cos of the orthoprojection's geodetic-to-ECEF
# step, held to DEM_ECEF_ULPS fp32 ulps a coordinate: the card's sinf/cosf
# are within 2 ulps of the true values, the CPU's within 1, and x and y are
# products of two of them (measured 3 ulps, D4, PERF.md §6)
DEM_ECEF_ULPS = 4



def stereo_dem_steps(scene, n, dev):
    """The timed chain as (name, step) pairs; each step reads and writes the
    state dict (``left``/``right``: the rendered images on ``dev``)."""
    import torch
    from visionworkbench_torch.cartography import colormap, hillshade, point_image_to_dem
    from visionworkbench_torch.stereo.stereo_model import StereoModel
    g = scene["dem"].shape[0]

    def rectify(st):
        st["rect_l"], st["rect_r"] = sds.rectify(scene)

    def warp(st):
        st["img_l"], st["mask_l"] = sds.warp(st["left"], scene["left"], st["rect_l"], n)
        st["img_r"], st["mask_r"] = sds.warp(st["right"], scene["right"], st["rect_r"], n)

    def correlate(st):
        st["dm"] = _bench_run(st["img_l"], st["img_r"], dev, left_mask=st["mask_l"],
                              right_mask=st["mask_r"])

    def triangulate(st):
        st["xyz"], st["err"], st["valid"] = StereoModel(
            st["rect_l"], st["rect_r"]).point_cloud(st["dm"])

    def dem(st):
        d, v = point_image_to_dem(st["xyz"], st["valid"], scene["dem_georef"], g, g)
        st["dem"], st["dem_valid"] = torch.where(v, d, sds.DEM_NODATA), v

    def shade(st):
        st["shade"] = hillshade(st["dem"], scale=scene["cell_m"], nodata=sds.DEM_NODATA).data

    def color(st):
        st["rgb"] = colormap(st["dem"], nodata=sds.DEM_NODATA, shade=st["shade"])

    return [("rectify", rectify), ("warp", warp), ("correlate", correlate),
            ("triangulate", triangulate), ("dem", dem), ("hillshade", shade),
            ("colormap", color)]


def _dem_timed(steps, st, reps=DEM_REPS, warmup=2):
    """Median ms of each step and of the chain over ``reps`` chains after
    ``warmup`` (CUDA events between the steps)."""
    import torch
    for _ in range(warmup):
        for _, step in steps:
            step(st)
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
        evs[0].record()
        for (_, step), ev in zip(steps, evs[1:]):
            step(st)
            ev.record()
        runs.append(evs)
    torch.cuda.synchronize()
    ms = {name: statistics.median(r[i].elapsed_time(r[i + 1]) for r in runs)
          for i, (name, _) in enumerate(steps)}
    ms["chain"] = statistics.median(r[0].elapsed_time(r[-1]) for r in runs)
    return ms


def _dem_profile(step, st):
    """(device ms, device launches) of one run of ``step`` (torch.profiler;
    kernels, copies and fills), or (None, None) when it saw nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(st)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, None
    return (sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def _corr_gate(st, d_true, v_true, tag, key, out):
    """The correlator's gate: on the core pixels whose true right pixel lies
    inside the right mask (and the left mask), >= DEM_SHARE valid and within
    DEM_CORR_PX of the true disparity. Returns the pixels held and |d|."""
    n = d_true.shape[0]
    d, v = st["dm"].to_numpy()
    ys, xs = np.mgrid[0:n, 0:n]
    rx = np.round(xs + d_true[..., 0]).astype(np.int64)
    ry = np.round(ys + d_true[..., 1]).astype(np.int64)
    inside = (rx >= 0) & (rx < n) & (ry >= 0) & (ry < n)
    mask_r = st["mask_r"].cpu().numpy()
    inside &= mask_r[np.clip(ry, 0, n - 1), np.clip(rx, 0, n - 1)]
    inside &= v_true & st["mask_l"].cpu().numpy()
    core = np.zeros((n, n), bool)
    core[DEM_MARGIN:-DEM_MARGIN, DEM_MARGIN:-DEM_MARGIN] = True
    sel = core & inside
    err = np.abs(d - d_true).max(-1)
    share = float((v & (err <= DEM_CORR_PX))[sel].mean())
    out[f"{key}_corr_valid"] = float(v[sel].mean())
    out[f"{key}_corr_share"] = share
    out[f"{key}_corr_median_px"] = float(np.median(err[sel & v]))
    print(f"[{tag}] correlator: {int(sel.sum())} core pixels with the true right pixel "
          f"inside, valid {out[f'{key}_corr_valid']:.4f}, within {DEM_CORR_PX} px of the "
          f"true disparity {share:.4f} (median |d| {out[f'{key}_corr_median_px']:.4f} px; "
          f"true disparity {d_true[..., 0][sel].min():.3f} .. {d_true[..., 0][sel].max():.3f} px)")
    if share < DEM_SHARE:
        raise SystemExit(f"{tag}: the correlator's share within {DEM_CORR_PX} px "
                         f"is {share:.4f} < {DEM_SHARE}")
    return sel & v, err


def _dem_bound(f_px):
    """Z^2 / (f b) * DEM_CORR_PX + 1 m, the DEMs' gate."""
    return sds.DEM_ALT_M ** 2 / (f_px * sds.DEM_BASELINE_M) * DEM_CORR_PX + 1.0


def _dem_gate(dem, dem_valid, true_dem, bound, tag, key, out, cells=None, what="DEM"):
    """The DEM's gate: >= DEM_SHARE of its valid cells (of ``cells``, when
    given) within ``bound`` m of the true DEM."""
    dem_v = dem_valid.cpu().numpy() & (True if cells is None else cells)
    g = dem_v.shape[0]
    derr = np.abs(dem.cpu().numpy() - true_dem)[dem_v]
    out[f"{key}_dem_share"] = float((derr <= bound).mean())
    out[f"{key}_dem_median_m"] = float(np.median(derr))
    out[f"{key}_dem_cells"] = float(dem_v.mean())
    print(f"[{tag}] {what}: {int(dem_v.sum())} of {g * g} cells, within {bound:.4f} m of "
          f"the true DEM {out[f'{key}_dem_share']:.4f}, median |dz| "
          f"{out[f'{key}_dem_median_m']:.4f} m, max {derr.max():.4f} m")
    if out[f"{key}_dem_share"] < DEM_SHARE:
        raise SystemExit(f"{tag}: the {what}'s share within {bound:.2f} m is "
                         f"{out[f'{key}_dem_share']:.4f} < {DEM_SHARE}")


def _points_gate(xyz, valid, truth, sel, bound, tag, key, out, what="every pixel"):
    """Points (fp32 tensors) within ``bound`` m of their float64 truth on
    every pixel of ``sel``, which must all be valid."""
    xyz, valid = xyz.cpu().numpy(), valid.cpu().numpy()
    perr = np.linalg.norm(xyz - truth, axis=-1)[sel]
    out[f"{key}_max_m"] = float(perr.max())
    out[f"{key}_median_m"] = float(np.median(perr))
    print(f"[{tag}] points from the true disparity against float64 ({what}): median "
          f"{np.median(perr):.4f} m, max {perr.max():.4f} m on {int(sel.sum())} pixels")
    if not valid[sel].all() or perr.max() > bound:
        raise SystemExit(f"{tag}: the points from the true disparity ({what}) are off by "
                         f"{perr.max():.4f} m (> {bound})")


def _true_points(cams, d_true, v_true, dev):
    """The fp32 pixel pairs of a true disparity and the port's point cloud
    of it (``StereoModel``)."""
    import torch
    from visionworkbench_torch.stereo.correlation import DisparityMap
    from visionworkbench_torch.stereo.stereo_model import StereoModel
    n = d_true.shape[0]
    d32 = d_true.astype(np.float32)
    xyz, _, valid = StereoModel(*cams).point_cloud(
        DisparityMap(torch.as_tensor(d32, device=dev), torch.as_tensor(v_true, device=dev)))
    pix1 = np.stack(np.meshgrid(np.arange(n), np.arange(n)), -1).astype(np.float32)
    return pix1, pix1 + d32, xyz, valid


def _to_cpu(v):
    """A tensor or a disparity map on the CPU; anything else as it is."""
    from visionworkbench_torch.stereo.correlation import DisparityMap
    if isinstance(v, DisparityMap):
        return DisparityMap(v.disparity.cpu(), v.valid.cpu())
    return v.cpu() if hasattr(v, "cpu") else v


def _steps_vs_cpu(st, steps, names, outputs):
    """Each named step on the CPU from the card's own inputs to it; its
    outputs beside the card's: {key: (cpu, card)}."""
    fns = dict(steps)
    pairs = {}
    for name in names:
        cpu = {k: _to_cpu(v) for k, v in st.items()}
        fns[name](cpu)
        pairs.update({k: (cpu[k], st[k]) for k in outputs[name]})
    return pairs


def _check_equal(pairs, tag, out, key, dem_ulps=0):
    """Every (cpu, card) pair equal, but a DEM's heights, held within
    ``dem_ulps`` fp32 ulps (its unequal cells counted); prints them."""
    checks = {k: _same(a, b) for k, (a, b) in pairs.items()}
    cells = {k: (_ulps(a, b), int((a.cpu() != b.cpu()).sum())) for k, (a, b) in pairs.items()
             if k == "dem"}
    print(f"[{tag}] card vs CPU (equal, max |d|): " + ", ".join(
        f"{k} {eq} {d:.3e}" for k, (eq, d) in checks.items()) + "".join(
        f"; {k}: {n} cells unequal, {u:.1f} fp32 ulps (bound {dem_ulps})"
        for k, (u, n) in cells.items()))
    out.update({f"{key}_cpu_{k}": d for k, (_, d) in checks.items()})
    out.update({f"{key}_cpu_{k}_cells": n for k, (_, n) in cells.items()})
    bad = [k for k, (eq, _) in checks.items()
           if not (eq or (k in cells and cells[k][0] <= dem_ulps))]
    if bad:
        raise SystemExit(f"{tag}: the card and the CPU disagree on {bad}")


def _dem_gates(st, scene, n, dev, out):
    """The correlator, triangulation, DEM and CAHV gates of stereo-dem."""
    import torch
    from visionworkbench_torch.camera import pinhole_to_cahv
    from visionworkbench_torch.stereo.stereo_model import StereoModel
    rect_l, rect_r = st["rect_l"], st["rect_r"]
    depth, v_true = sds.depth(rect_l, scene, n, dev)
    d_true = sds.disparity(rect_l, rect_r, depth)
    _corr_gate(st, d_true, v_true, "stereo-dem", "stereo_dem", out)
    # triangulation of the true disparity against the float64 oracle: the
    # chain's pair, and the same pair with its float64 centres (off the fp32
    # grid, where the JAX package's fp32 route is metres off)
    pairs = {"chain": (rect_l, rect_r),
             "float64_centres": sds.rectify(sds.scene(n, fp32_centres=False))}
    for what, (cl, cr) in pairs.items():
        pix1, pix2, xyz, valid = _true_points((cl, cr), sds.disparity(cl, cr, depth), v_true,
                                              dev)
        _points_gate(xyz, valid, sds.triangulate64(cl, cr, pix1, pix2), v_true,
                     sds.DEM_POINT_M, "stereo-dem", f"stereo_dem_point_{what}", out, what)
    # the DEM from the correlated disparity against the true DEM
    _dem_gate(st["dem"], st["dem_valid"], scene["dem"], _dem_bound(rect_l.fu), "stereo-dem",
              "stereo_dem", out)
    # the CAHV route against the pinhole route on the correlated map
    cxyz, _, cvalid = StereoModel(pinhole_to_cahv(rect_l),
                                  pinhole_to_cahv(rect_r)).point_cloud(st["dm"])
    both = (cvalid & st["valid"]).cpu().numpy()
    cerr = np.linalg.norm((cxyz - st["xyz"]).double().cpu().numpy(), axis=-1)[both]
    out["stereo_dem_cahv_max_m"] = float(cerr.max())
    print(f"[stereo-dem] CAHV route against the pinhole route: validity differs at "
          f"{int((cvalid != st['valid']).sum())} pixels, max {cerr.max():.4f} m, median "
          f"{np.median(cerr):.4f} m")
    if not torch.equal(cvalid, st["valid"]) or cerr.max() > sds.DEM_CAHV_M:
        raise SystemExit(f"stereo-dem: the CAHV route is off by {cerr.max():.4f} m")


def _test_pinhole():
    """``tests/test_camera.py``'s ``_test_camera``."""
    from visionworkbench_torch.camera import PinholeModel
    from visionworkbench_torch.math.quaternion import euler_to_rotation_matrix
    return PinholeModel((10.0, -5.0, 2.0), euler_to_rotation_matrix(0.1, -0.2, 0.05).numpy(),
                        (500.0, 510.0), (320.0, 240.0))


def stereo_dem_round_trip_models(scene):
    """The round trips' models: the phase's left TSAI pinhole moved to the
    origin (its ECEF centre rounds to 0.5 m in fp32), and CAHVOR and CAHVORE
    (linearities 1, 0.5, 0) built on ``_test_camera`` as
    ``tests/test_camera.py:84-85, 151-156`` build them."""
    from visionworkbench_torch.camera import (
        CAHVOREModel, CAHVORModel, PinholeModel, pinhole_to_cahv)
    left = scene["left"]
    base = pinhole_to_cahv(_test_pinhole())
    radial = (0.0, -0.001, 0.0002)
    models = {"tsai": PinholeModel((0.0, 0.0, 0.0), left.R, (left.fu, left.fv),
                                   (left.cu, left.cv), left.distortion),
              "cahvor": CAHVORModel(base.C, base.A, base.H, base.V, base.A, radial)}
    for p in (1.0, 0.5, 0.0):
        models[f"cahvore_{p:g}"] = CAHVOREModel(base.C, base.A, base.H, base.V, base.A,
                                                radial, (0.0005, -0.0002, 0.0001), p)
    return models


def _round_trips(scene, n, dev, out):
    """pixel -> ray -> point -> pixel and ray -> pixel -> ray at every pixel
    of n^2, within ``DEM_RT``."""
    import torch
    pix = sds.pixel_grid(n, dev)
    for name, cam in stereo_dem_round_trip_models(scene).items():
        tol_px, tol_ray, dist = DEM_RT[name]
        _sync(dev)
        t0 = time.perf_counter()
        rays = cam.pixel_to_vector(pix)
        back = cam.point_to_pixel(cam.camera_center(pix) + rays * dist)
        rays2 = cam.pixel_to_vector(back)
        _sync(dev)
        wall = time.perf_counter() - t0
        e_px = float((back - pix).abs().max())
        e_ray = float((rays2 - rays).abs().max())
        out[f"stereo_dem_rt_{name}_px"] = e_px
        out[f"stereo_dem_rt_{name}_ray"] = e_ray
        print(f"[stereo-dem] round trip {name} at {n}^2: max |pixel| {e_px:.3e} px "
              f"(bound {tol_px}), max |ray| {e_ray:.3e} (bound {tol_ray}), "
              f"{wall * 1e3:.4f} ms (three calls)")
        if not (e_px <= tol_px and e_ray <= tol_ray):
            raise SystemExit(f"stereo-dem: round trip {name} off: {e_px} px, {e_ray}")


def _same(a, b):
    """(equal, max |a - b|) of two tensors or arrays, NaNs equal to NaNs."""
    a, b = (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x) for x in (a, b))
    if a.shape != b.shape:
        return False, float("inf")
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == "f" else a == b
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return bool(same.all()), float(np.nanmax(diff)) if diff.size else 0.0


def _ulps(a, b):
    """Largest |a - b| of two fp32 tensors in fp32 ulps of the larger magnitude."""
    a, b = a.cpu().double().numpy(), b.cpu().double().numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32)).astype(np.float64)
    return float((np.abs(a - b) / ulp).max())


def _dem_ortho(st, scene, n, dev, out):
    """``orthoproject`` of the left image onto the recovered DEM through
    ``Map2CamTrans`` (an n^2 map over the DEM's area), on the card and on
    the CPU, held piece by piece: the card's orthoimage is its own ground
    points' lon/lat/height -> ECEF -> ``point_to_pixel`` -> ``sample``; the
    CPU's lon/lat/height equal the card's; its ECEF points of the card's
    lon/lat/height lie within DEM_ECEF_ULPS of the card's; its
    ``point_to_pixel`` and ``sample`` of the card's points and pixels equal
    the card's."""
    from visionworkbench_torch.cartography import GeoReference, Map2CamTrans, orthoproject
    from visionworkbench_torch.image.transform import _dest_grid, sample
    g = scene["dem_georef"]
    t = g.transform.copy()
    t[0, 0] *= scene["dem"].shape[1] / n
    t[1, 1] *= scene["dem"].shape[0] / n
    georef = GeoReference(g.datum, g.projection, t)
    cam = scene["left"]
    ortho, llh, xyz, pix, samp = {}, {}, {}, {}, {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        img, dem = st["left"].to(d), st["dem"].to(d)
        _sync(dev)
        t0 = time.perf_counter()
        ortho[tag] = orthoproject(img, cam, georef, (n, n), dem=dem, dem_georef=g,
                                  dem_nodata=sds.DEM_NODATA)
        _sync(dev)
        out[f"stereo_dem_ortho_{tag}_ms"] = (time.perf_counter() - t0) * 1e3
        llh[tag] = Map2CamTrans(cam, georef, dem, g, sds.DEM_NODATA).ground_llh(
            *_dest_grid(n, n, img.device))
    for tag, d in (("card", dev), ("cpu", "cpu")):
        xyz[tag] = g.datum.geodetic_to_cartesian(llh["card"].to(d))
        pix[tag] = cam.point_to_pixel(xyz["card"].to(d))
        samp[tag] = sample(st["left"].to(d), *pix["card"].to(d).unbind(-1), interp="bilinear",
                           edge="zero")
    ulps = _ulps(xyz["card"], xyz["cpu"])
    checks = {"card orthoimage = its pieces": _same(samp["card"], ortho["card"]),
              "lon/lat/height": _same(llh["cpu"], llh["card"]),
              "point_to_pixel": _same(pix["cpu"], pix["card"]),
              "sample": _same(samp["cpu"], samp["card"])}
    whole = (ortho["card"] - ortho["cpu"].to(dev)).abs()
    out.update(stereo_dem_ortho_ecef_ulps=ulps, stereo_dem_ortho_max=float(whole.max()),
               stereo_dem_ortho_equal=float((whole == 0).float().mean()))
    print(f"[stereo-dem] orthoproject {n}^2: card {out['stereo_dem_ortho_card_ms']:.4f} ms, "
          f"CPU {out['stereo_dem_ortho_cpu_ms']:.4f} ms; ECEF ground points card vs CPU "
          f"{ulps:.1f} ulps (bound {DEM_ECEF_ULPS}); " + ", ".join(
              f"{k} {eq} {dd:.3e}" for k, (eq, dd) in checks.items())
          + f"; whole orthoimages card vs CPU: max |d| {out['stereo_dem_ortho_max']:.3e}, equal "
          f"on {out['stereo_dem_ortho_equal']:.6f}")
    bad = [k for k, (eq, _) in checks.items() if not eq]
    if bad or ulps > DEM_ECEF_ULPS:
        raise SystemExit(f"stereo-dem: the orthoprojection differs between the card and the "
                         f"CPU: {bad}, ground points {ulps} ulps")


def _dem_tools(st, scene, dev, folder, out):
    """The three tools' ``main`` on files the phase writes (the left image
    with a ``.tsai`` from ``write_pinhole_model``; the recovered DEM as a
    GeoTIFF with nodata), on the card and on the CPU: ``undistort_image``,
    ``hillshade`` and ``colormap --hillshade``; their files equal."""
    from visionworkbench_torch.camera import write_pinhole_model
    from visionworkbench_torch.fileio import read_image, write_tiff
    from visionworkbench_torch.tools import colormap, hillshade, undistort_image
    img, tsai, dem = (os.path.join(folder, f) for f in ("left.tif", "left.tsai", "dem.tif"))
    write_tiff(img, st["left"].cpu().numpy())
    write_pinhole_model(tsai, scene["left"])
    write_tiff(dem, st["dem"].cpu().numpy(), georef=scene["dem_georef"], nodata=sds.DEM_NODATA)
    res = {}
    names = ("undistort_image", "hillshade", "colormap")
    for tag, d in (("card", dev), ("cpu", "cpu")):
        outs = [os.path.join(folder, f"{what}_{tag}{ext}") for what, ext in
                (("undist", ".tif"), ("shade", ".tif"), ("cmap", ".png"))]
        runs = ((undistort_image.main, [img, tsai, "-o", outs[0]]),
                (hillshade.main, [dem, "-o", outs[1]]),
                (colormap.main, [dem, "--hillshade", "-o", outs[2]]))
        for name, (main, argv) in zip(names, runs):
            rc, text, wall = _tool(main, argv, d)
            if rc != 0:
                raise SystemExit(f"stereo-dem: {name} exited {rc}: {text}")
            out[f"stereo_dem_{name}_{tag}_s"] = wall
        res[tag] = [read_image(p, None) for p in outs]
    checks = {k: _same(a, b) for k, a, b in zip(names, res["card"], res["cpu"])}
    out.update(stereo_dem_tool_undistort=checks["undistort_image"][1],
               stereo_dem_tool_shade=checks["hillshade"][1],
               stereo_dem_tool_rgb_lsb=checks["colormap"][1])
    print(f"[stereo-dem] tools (card / CPU wall, s): " + ", ".join(
        f"{k} {out[f'stereo_dem_{k}_card_s']:.4f} / {out[f'stereo_dem_{k}_cpu_s']:.4f}"
        for k in names) + "; card vs CPU files (equal, max |d|): " + ", ".join(
        f"{k} {eq} {dd:.3e}" for k, (eq, dd) in checks.items()))
    bad = [k for k, (eq, _) in checks.items() if not eq]
    if bad:
        raise SystemExit(f"stereo-dem: the tools' files differ between the card and the CPU: {bad}")


def _dem_launch_check(counts, tag="stereo-dem"):
    """The correlator step launches the bench frame's kernels of csrc/
    (band_sweep_kernel once a level, speckle 9 times); no other step
    launches any."""
    want = {"sweep": LEVELS + 1, "sweep/band": LEVELS + 1, "speckle": 9}
    for name, c in counts.items():
        expect = want if name == "correlate" else {}
        if any(c.get(k, 0) != expect.get(k, 0) for k in set(c) | set(expect)):
            raise SystemExit(f"{tag}: step {name} launched {c}, expected {expect}")


def _step_counts(steps, st, dev):
    """Each step once, its launches of csrc/ counted (0 before, read after)."""
    counts = {}
    for name, step in steps:
        _reset_counts()
        step(st)
        _sync(dev)
        counts[name] = {k: v for k, v in _read_counts().items() if v}
    return counts


def _time_chain(steps, st, tag, key, n, out):
    """Each step's ms (median of DEM_REPS chains after 2 warm-ups), device ms,
    launches and idle share, the chain's ms and Mp/s (n^2 over the chain) and
    the peak device memory, under ``key``_* of ``out``."""
    import torch
    ms = _dem_timed(steps, st)
    torch.cuda.reset_peak_memory_stats()
    for _, step in steps:
        step(st)
    out[f"{key}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    for name, step in steps:
        dev_ms, launches = _dem_profile(step, st)
        idle = None if dev_ms is None else 1 - dev_ms / ms[name]
        out.update({f"{key}_{name}_ms": ms[name], f"{key}_{name}_device_ms": dev_ms,
                    f"{key}_{name}_launches": launches, f"{key}_{name}_idle": idle})
        print(f"[time] {tag} {name}: {ms[name]:.4f} ms, device {dev_ms} ms in "
              f"{launches} launches, idle share {idle}")
    out[f"{key}_chain_ms"] = ms["chain"]
    out[f"{key}_chain_mps"] = n * n / (ms["chain"] * 1e3)
    print(f"[time] {tag} chain: {ms['chain']:.4f} ms (median of {DEM_REPS} after 2 "
          f"warm-ups), {out[f'{key}_chain_mps']:.3f} Mp/s, peak device memory "
          f"{out[f'{key}_peak_mib']:.1f} MiB")


def phase_stereo_dem(dev, smi, n=sds.DEM_N):
    """stereo-dem-1024 (see the module docstring, phase 8). Returns the
    ``stereo_dem_*`` numbers and the correlator step's launches of csrc/."""
    import torch
    out = {}
    t_phase = time.perf_counter()
    scene = sds.scene(n)
    st = {"left": sds.render(scene["left"], scene, n, dev),
          "right": sds.render(scene["right"], scene, n, dev)}
    _sync(dev)
    out["stereo_dem_render_s"] = time.perf_counter() - t_phase
    print(f"[stereo-dem] rendered the pair at {n}^2 in {out['stereo_dem_render_s']:.4f} s")
    steps = stereo_dem_steps(scene, n, dev)
    counts = _step_counts(steps, st, dev)
    print(f"[stereo-dem] launches of csrc/ by step: {counts}")
    _dem_gates(st, scene, n, dev, out)
    _reset_counts()
    _round_trips(scene, n, dev, out)
    _check_equal(_steps_vs_cpu(st, steps, ("warp", "triangulate", "dem", "hillshade", "colormap"),
                               {"warp": ("img_l", "img_r", "mask_l", "mask_r"),
                                "triangulate": ("xyz", "err", "valid"),
                                "dem": ("dem", "dem_valid"), "hillshade": ("shade",),
                                "colormap": ("rgb",)}),
                 "stereo-dem", out, "stereo_dem")
    _dem_ortho(st, scene, n, dev, out)
    folder = tempfile.mkdtemp(prefix="chip_smoke_stereo_dem_")
    try:
        _dem_tools(st, scene, dev, folder, out)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    _sync(dev)
    counts["other"] = {k: v for k, v in _read_counts().items() if v}
    if torch.device(dev).type == "cuda":   # the plain versions count nothing
        _dem_launch_check(counts)
    if torch.device(dev).type == "cuda":
        _time_chain(steps, st, "stereo-dem", "stereo_dem", n, out)
    out["stereo_dem_phase_s"] = time.perf_counter() - t_phase
    print(f"[stereo-dem] phase wall {out['stereo_dem_phase_s']:.4f} s on {smi}")
    return out, counts["correlate"]


# ---- phase 9: the rest of the camera layer --------------------------------------

# opticalbar-dem-1024, bathy-dem-1024 and bayer-1024 over stereo-dem's place,
# DEM and texture (stereo_dem_scene.py holds the scenes and float64 oracles)
OB_POINT_M = 0.6             # opticalbar points from the true disparity against float64
BATHY_POINT_M = 0.6          # bathy points (BathyStereoModel under water) against float64
ROUND_TRIP_PX = 1.0          # point_to_pixel / solve_point_to_pixel of the rendered points
FIT_POINTS = (6, 4)          # fit_pinhole: a 6 x 4 grid of the left image's ground points
FIT_PERTURB = (5.0, 5e-3)    # the seed camera: its centre moved (m), rotated (rad)
FIT_PX = 1.0                 # fit_pinhole's reprojection error, max over the points
BATHY_SHALLOW = 0.9          # the refraction-free depth over the refracted one, median
# card against CPU where sin/cos are involved (the optical-bar rays): the
# rays within OB_RAY_UNITS units of 2^-24 (CUDA's sinf/cosf within 2 ulps, the
# CPU's within 1, the rotation and the norm a few roundings more), the
# float64 intersection of those rays rounded to fp32 within OB_POINT_ULPS
# fp32 ulps, its error norm within OB_ERR_M; every other check is equality
OB_RAY_UNITS = 8
OB_POINT_ULPS = 2
OB_ERR_M = 1e-2
# a DEM's cells from the same points: float64 geodetic heights (the card's
# and the CPU's float64 sin/cos/atan2 may differ by an ulp, and p / cos(lat)
# - N cancels ~6.4e6 m down to ~50 m, so a height moves by ~1e-9 m) rounded
# to fp32, so a cell next to a rounding boundary may differ by one fp32 ulp
DEM_CELL_ULPS = 1
BAYER_SEEDS = (11, 12, 13)   # the red, green and blue textures of bayer-1024


def opticalbar_dem_steps(scene, cams, n, dev):
    """opticalbar-dem's timed chain: the correlator on the unrectified pair
    (OB_SEARCH, masks of where each ray hits the DEM), ``StereoModel`` with
    the per-pixel float64 centres, the DEM and its hillshade."""
    from visionworkbench_torch.math.bbox import BBox2i
    from visionworkbench_torch.stereo.pyramid_correlation import pyramid_correlate
    from visionworkbench_torch.stereo.stereo_model import StereoModel
    base = dict(stereo_dem_steps(scene, n, dev))

    def correlate(st):
        st["dm"] = pyramid_correlate(st["left"], st["right"], BBox2i(*sds.OB_SEARCH),
                                     kernel_size=KERNEL, max_pyramid_levels=LEVELS,
                                     tile_size=TILE, subpixel="parabola", device=dev,
                                     left_mask=st["mask_l"], right_mask=st["mask_r"])

    def triangulate(st):
        st["xyz"], st["err"], st["valid"] = StereoModel(*cams).point_cloud(st["dm"])

    return [("correlate", correlate), ("triangulate", triangulate), ("dem", base["dem"]),
            ("hillshade", base["hillshade"])]


def bathy_dem_steps(scene, plane, n, dev):
    """bathy-dem's timed chain: stereo-dem's rectification, warps and
    correlator; ``StereoModel`` on every pixel and ``BathyStereoModel`` on
    the pixels whose point lies below the water plane, merged; the DEM and
    its hillshade."""
    import torch
    from visionworkbench_torch.cartography import BathyStereoModel
    from visionworkbench_torch.core.device import dot
    base = dict(stereo_dem_steps(scene, n, dev))
    normal, level = plane[:3].tolist(), float(plane[3])

    def triangulate(st):
        base["triangulate"](st)
        d = st["dm"].disparity
        pix1 = sds.pixel_grid(n, d.device)
        bxyz, berr = BathyStereoModel(st["rect_l"], st["rect_r"], plane).triangulate(
            pix1, pix1 + d)
        under = st["valid"] & (dot(st["xyz"].double(), normal) < level)
        st["xyz"] = torch.where(under[..., None], bxyz, st["xyz"])
        st["err"] = torch.where(under, berr, st["err"])
        st["under"] = under

    return [(k, base[k]) for k in ("rectify", "warp", "correlate")] + [
        ("triangulate", triangulate), ("dem", base["dem"]), ("hillshade", base["hillshade"])]


def _units(a, b, unit):
    """Largest |a - b| of two tensors in units of ``unit``."""
    return float((a.cpu().double() - b.cpu().double()).abs().max()) / unit


def _ob_vs_cpu(st, steps, cams, n, dev, out):
    """Card against CPU on opticalbar-dem: the left rays within OB_RAY_UNITS
    of 2^-24; the triangulation of the card's disparity map within
    OB_POINT_ULPS (points) and OB_ERR_M (error), validity equal; the DEM of
    the card's points and the hillshade of the card's DEM equal."""
    import torch
    grid = sds.pixel_grid(n, dev)
    rays = _units(cams[0].pixel_to_vector(grid), cams[0].pixel_to_vector(grid.cpu()), 2.0 ** -24)
    pairs = _steps_vs_cpu(st, steps, ("triangulate",), {"triangulate": ("xyz", "err", "valid")})
    ulps = _ulps(*pairs["xyz"])
    err = _units(*pairs["err"], 1.0)
    valid = torch.equal(pairs["valid"][0], pairs["valid"][1].cpu())
    out.update(opticalbar_dem_cpu_ray_units=rays, opticalbar_dem_cpu_point_ulps=ulps,
               opticalbar_dem_cpu_err_m=err)
    print(f"[opticalbar-dem] card vs CPU: rays {rays:.1f} units of 2^-24 (bound "
          f"{OB_RAY_UNITS}), points {ulps:.1f} fp32 ulps (bound {OB_POINT_ULPS}), error norm "
          f"{err:.3e} m (bound {OB_ERR_M}), validity equal {valid}")
    if rays > OB_RAY_UNITS or ulps > OB_POINT_ULPS or err > OB_ERR_M or not valid:
        raise SystemExit("opticalbar-dem: the card and the CPU disagree beyond their bounds")
    _check_equal(_steps_vs_cpu(st, steps, ("dem", "hillshade"),
                               {"dem": ("dem", "dem_valid"), "hillshade": ("shade",)}),
                 "opticalbar-dem", out, "opticalbar_dem", DEM_CELL_ULPS)


def _timed_call(fn, dev):
    """(result, wall s, device ms, device launches) of ``fn()``: the wall of
    one call, then the profiler's device time and launches of another."""
    import torch
    _sync(dev)
    t0 = time.perf_counter()
    res = fn()
    _sync(dev)
    wall = time.perf_counter() - t0
    if torch.device(dev).type != "cuda":
        return res, wall, None, None
    dev_ms, launches = _dem_profile(lambda st: st.update(r=fn()), {})
    return res, wall, dev_ms, launches


def _ob_round_trips(cams, xyz, hit, n, dev, out):
    """``OpticalBarModel.point_to_pixel`` (25 steps from the image centre)
    and ``solve_point_to_pixel`` (25 steps from (0, 0)) of every rendered
    ground point of the left image (on its pixel's float64 ray at the
    rendered range, ``sds.ob_ground64``, rounded to fp32), one call each,
    within ROUND_TRIP_PX of the rendered pixel."""
    import torch
    from visionworkbench_torch.camera import solve_point_to_pixel
    left = cams[0]
    pts = torch.as_tensor(sds.ob_ground64(left, xyz), dtype=torch.float32, device=xyz.device)[hit]
    want = sds.pixel_grid(n, dev)[hit]
    runs = {"point_to_pixel": lambda: left.point_to_pixel(pts),
            "solve_point_to_pixel": lambda: solve_point_to_pixel(left, pts)}
    for name, fn in runs.items():
        fn_small = {"point_to_pixel": lambda: left.point_to_pixel(pts[:1024]),
                    "solve_point_to_pixel": lambda: solve_point_to_pixel(left, pts[:1024])}[name]
        fn_small()                       # the first forward-mode call's one-time set-up
        got, wall, dev_ms, launches = _timed_call(fn, dev)
        e = (got - want).abs().max(-1).values.cpu().numpy()
        out.update({f"opticalbar_dem_{name}_median_px": float(np.median(e)),
                    f"opticalbar_dem_{name}_max_px": float(e.max()),
                    f"opticalbar_dem_{name}_s": wall, f"opticalbar_dem_{name}_device_ms": dev_ms,
                    f"opticalbar_dem_{name}_launches": launches})
        print(f"[opticalbar-dem] {name} of {pts.shape[0]} rendered points: median "
              f"{np.median(e):.4f} px, max {e.max():.4f} px (bound {ROUND_TRIP_PX}); wall "
              f"{wall:.4f} s, device {dev_ms} ms in {launches} launches")
        if not e.max() <= ROUND_TRIP_PX:
            raise SystemExit(f"opticalbar-dem: {name} misses by {e.max():.4f} px")


def _fit_seed(cam):
    """The camera moved by FIT_PERTURB[0] m and rotated by FIT_PERTURB[1] rad
    about a fixed axis."""
    from visionworkbench_torch.camera import PinholeModel
    from visionworkbench_torch.camera.linescan import vector_to_transform
    axis = np.array([1.0, -2.0, 0.5]) / np.linalg.norm([1.0, -2.0, 0.5])
    rot = vector_to_transform(np.concatenate([np.zeros(3), axis * FIT_PERTURB[1], [1.0]]))[0]
    return PinholeModel(cam.C + FIT_PERTURB[0] * axis, rot @ cam.R, (cam.fu, cam.fv),
                        (cam.cu, cam.cv), cam.distortion, cam.pixel_pitch)


def _fit(scene, n, dev, out):
    """``fit_pinhole`` on the card: stereo-dem's left pinhole from the seed
    of :func:`_fit_seed` and FIT_POINTS of its ground points (each pixel's
    DEM hit's range taken along its ray from the centre in float64: the fp32
    march leaves hits up to ~2 m off their rays); the reprojection error
    within FIT_PX; the same fit on the CPU equal (the pinhole's projection
    is card = CPU, the LM host NumPy)."""
    import torch
    from visionworkbench_torch.cartography import camera_pixel_to_dem_xyz, fit_pinhole
    cam = scene["left"]
    gx, gy = np.meshgrid(np.linspace(0.1, 0.9, FIT_POINTS[0]) * (n - 1),
                         np.linspace(0.1, 0.9, FIT_POINTS[1]) * (n - 1))
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    hits, hit = camera_pixel_to_dem_xyz(pix, cam, scene["dem"], scene["dem_georef"], device=dev)
    if not bool(hit.all()):
        raise SystemExit("fit: a ground point missed the DEM")
    rays = cam.pixel_to_vector(torch.as_tensor(pix, device=hits.device)).double().cpu().numpy()
    dist = np.linalg.norm(hits.double().cpu().numpy() - cam.C, axis=-1)
    xyz64 = cam.C + rays * dist[:, None]
    xyz = torch.as_tensor(xyz64, dtype=torch.float32, device=hits.device)
    seed = _fit_seed(cam)
    fit, wall, dev_ms, launches = _timed_call(lambda: fit_pinhole(xyz64, pix, seed, device=dev),
                                              dev)
    cpu = fit_pinhole(xyz64, pix, seed, device="cpu")
    reproj = float((fit.point_to_pixel(xyz) - torch.as_tensor(pix, device=xyz.device))
                   .abs().max())
    same = bool(np.array_equal(fit.C, cpu.C) and np.array_equal(fit.R, cpu.R))
    out.update(fit_pinhole_px=reproj, fit_pinhole_centre_m=float(np.linalg.norm(fit.C - cam.C)),
               fit_pinhole_s=wall, fit_pinhole_device_ms=dev_ms, fit_pinhole_launches=launches)
    print(f"[fit] fit_pinhole from {len(pix)} ground points, seed {FIT_PERTURB[0]} m / "
          f"{FIT_PERTURB[1]} rad off: reprojection max {reproj:.4f} px (bound {FIT_PX}), "
          f"centre {out['fit_pinhole_centre_m']:.4f} m from the truth (seed "
          f"{np.linalg.norm(seed.C - cam.C):.4f}); wall {wall:.4f} s, device {dev_ms} ms in "
          f"{launches} launches; card = CPU {same}")
    if not (reproj <= FIT_PX and same):
        raise SystemExit(f"fit: reprojection {reproj} px, card = CPU {same}")


def _opticalbar(dev, n, out):
    """opticalbar-dem-n (see the module docstring, phase 9). Returns its
    steps' launches of csrc/."""
    import torch
    t0 = time.perf_counter()
    scene = sds.scene(n)
    cams = sds.optical_bar_pair(n)
    hits = [sds._dem_hits(c, scene, n, dev) for c in cams]
    st = {"left": sds.texture_at(scene, *hits[0]), "right": sds.texture_at(scene, *hits[1]),
          "mask_l": hits[0][1], "mask_r": hits[1][1]}
    _sync(dev)
    out["opticalbar_dem_render_s"] = time.perf_counter() - t0
    print(f"[opticalbar-dem] rendered the pair at {n}^2 in "
          f"{out['opticalbar_dem_render_s']:.4f} s")
    steps = opticalbar_dem_steps(scene, cams, n, dev)
    counts = _step_counts(steps, st, dev)
    print(f"[opticalbar-dem] launches of csrc/ by step: {counts}")
    d_true, v_true = sds.ob_truth(*cams, scene, n, dev)
    _corr_gate(st, d_true, v_true, "opticalbar-dem", "opticalbar_dem", out)
    pix1, pix2, xyz, valid = _true_points(cams, d_true, v_true, dev)
    _points_gate(xyz, valid, sds.ob_triangulate64(*cams, pix1, pix2), v_true, OB_POINT_M,
                 "opticalbar-dem", "opticalbar_dem_point", out)
    _dem_gate(st["dem"], st["dem_valid"], scene["dem"], _dem_bound(sds.OB_F_M / cams[0].pitch),
              "opticalbar-dem", "opticalbar_dem", out)
    _reset_counts()
    _ob_round_trips(cams, *hits[0], n, dev, out)
    _fit(scene, n, dev, out)
    _ob_vs_cpu(st, steps, cams, n, dev, out)
    _sync(dev)
    counts["other"] = {k: v for k, v in _read_counts().items() if v}
    if torch.device(dev).type == "cuda":
        _dem_launch_check(counts, "opticalbar-dem")
        _time_chain(steps, st, "opticalbar-dem", "opticalbar_dem", n, out)
    return counts


def _bathy(dev, n, out):
    """bathy-dem-n (see the module docstring, phase 9). Returns its steps'
    launches of csrc/."""
    import torch
    from visionworkbench_torch.cartography import BathyStereoModel, point_image_to_dem
    t0 = time.perf_counter()
    scene = sds.scene(n)
    plane = sds.water_plane()
    st = {k: sds.render_refracted(scene[k], scene, n, dev, plane)[0] for k in ("left", "right")}
    _sync(dev)
    out["bathy_dem_render_s"] = time.perf_counter() - t0
    print(f"[bathy-dem] rendered the pair through the water at {n}^2 in "
          f"{out['bathy_dem_render_s']:.4f} s")
    steps = bathy_dem_steps(scene, plane, n, dev)
    counts = _step_counts(steps, st, dev)
    print(f"[bathy-dem] launches of csrc/ by step: {counts}")
    rect = (st["rect_l"], st["rect_r"])
    d_true, v_true, under = sds.bathy_truth(*rect, scene, n, dev, plane)
    _corr_gate(st, d_true, v_true, "bathy-dem", "bathy_dem", out)
    # the points of the true disparity: BathyStereoModel under the water,
    # StereoModel elsewhere, against their float64 oracles
    pix1, pix2, xyz, valid = _true_points(rect, d_true, v_true, dev)
    wet = torch.as_tensor(under & v_true, device=xyz.device)
    bxyz = BathyStereoModel(*rect, plane).triangulate(pix1, pix2, device=dev)[0]
    _points_gate(torch.where(wet[..., None], bxyz, xyz), valid,
                 np.where(under[..., None], sds.bathy_triangulate64(*rect, pix1, pix2, plane),
                          sds.triangulate64(*rect, pix1, pix2)),
                 under & v_true, BATHY_POINT_M, "bathy-dem", "bathy_dem_point_under", out,
                 "under the water, BathyStereoModel")
    _points_gate(xyz, valid, sds.triangulate64(*rect, pix1, pix2), ~under & v_true,
                 sds.DEM_POINT_M, "bathy-dem", "bathy_dem_point_dry", out, "on land, StereoModel")
    # the DEM, under the water and on land apart; the DEM of StereoModel
    # alone, whose depths under the water are shallower by about the index
    wet_cells = scene["dem"] < sds.DEM_WATER_M
    bound = _dem_bound(rect[0].fu)
    _dem_gate(st["dem"], st["dem_valid"], scene["dem"], bound, "bathy-dem", "bathy_dem_under",
              out, wet_cells, "DEM under the water")
    _dem_gate(st["dem"], st["dem_valid"], scene["dem"], bound, "bathy-dem", "bathy_dem_dry",
              out, ~wet_cells, "DEM on land")
    g = scene["dem"].shape[0]
    plain = {"dm": st["dm"], "rect_l": rect[0], "rect_r": rect[1]}
    dict(stereo_dem_steps(scene, n, dev))["triangulate"](plain)
    naive, nv = (t.cpu().numpy() for t in point_image_to_dem(
        plain["xyz"], plain["valid"], scene["dem_georef"], g, g))
    both = nv & st["dem_valid"].cpu().numpy() & wet_cells
    ratio = float(np.median((sds.DEM_WATER_M - naive[both])
                            / (sds.DEM_WATER_M - st["dem"].cpu().numpy()[both])))
    out["bathy_dem_naive_depth_ratio"] = ratio
    print(f"[bathy-dem] the refraction-free DEM's depths over the refracted DEM's on "
          f"{int(both.sum())} cells under the water: median {ratio:.4f} (1 / index "
          f"{1 / sds.WATER_INDEX:.4f}; bound {BATHY_SHALLOW})")
    if not ratio <= BATHY_SHALLOW:
        raise SystemExit(f"bathy-dem: the refraction-free depths are not shallower ({ratio})")
    _check_equal(_steps_vs_cpu(st, steps, ("triangulate", "dem", "hillshade"),
                               {"triangulate": ("xyz", "err", "valid", "under"),
                                "dem": ("dem", "dem_valid"), "hillshade": ("shade",)}),
                 "bathy-dem", out, "bathy_dem", DEM_CELL_ULPS)
    if torch.device(dev).type == "cuda":
        _dem_launch_check(counts, "bathy-dem")
        _time_chain(steps, st, "bathy-dem", "bathy_dem", n, out)
    return counts


def _bayer(dev, n, out):
    """bayer-n: ``bayer_demosaic`` of an n^2 mosaic of three bench textures
    in each of the four patterns, card = CPU; its error against the RGB
    truth; the RGGB call timed (median of DEM_REPS after 2 warm-ups)."""
    import torch
    from visionworkbench_torch.camera import bayer_demosaic
    from visionworkbench_torch.camera.bayer import PATTERNS
    rgb = np.stack([sds.texture(n, n - 80, s) for s in BAYER_SEEDS], -1)
    ys, xs = np.mgrid[0:n, 0:n] % 2
    _reset_counts()
    mosaics = {}
    for pattern, sites in PATTERNS.items():
        chan = np.full((n, n), 1)
        chan[(ys == sites[0][0]) & (xs == sites[0][1])] = 0
        chan[(ys == sites[3][0]) & (xs == sites[3][1])] = 2
        mosaic = mosaics[pattern] = np.take_along_axis(rgb, chan[..., None], -1)[..., 0]
        card = bayer_demosaic(torch.as_tensor(mosaic, device=dev), pattern)
        eq, d = _same(bayer_demosaic(mosaic, pattern, device="cpu"), card)
        mae = float(np.abs(card.cpu().numpy() - rgb).mean())
        out[f"bayer_{pattern}_mae"] = mae
        print(f"[bayer] {pattern} at {n}^2: card = CPU {eq} (max |d| {d:.3e}), mean |rgb - "
              f"truth| {mae:.4f}")
        if not eq:
            raise SystemExit(f"bayer: {pattern} differs between the card and the CPU")
    _sync(dev)
    if any(_read_counts().values()):
        raise SystemExit(f"bayer: launched {_read_counts()}")
    if torch.device(dev).type == "cuda":
        m = torch.as_tensor(mosaics["rggb"], device=dev)
        ms = _time_ms(lambda: bayer_demosaic(m, "rggb"), DEM_REPS)
        dev_ms, launches = _dem_profile(lambda st: bayer_demosaic(m, "rggb"), {})
        out.update(bayer_ms=ms, bayer_mps=n * n / (ms * 1e3), bayer_device_ms=dev_ms,
                   bayer_launches=launches)
        print(f"[time] bayer rggb {n}^2: {ms:.4f} ms ({out['bayer_mps']:.3f} Mp/s), "
              f"device {dev_ms} ms in {launches} launches")


def phase_cameras_ii(dev, smi, n=sds.DEM_N):
    """opticalbar-dem-n, bathy-dem-n and bayer-n (see the module docstring,
    phase 9). Returns the ``opticalbar_dem_*``, ``bathy_dem_*``, ``fit_*``
    and ``bayer_*`` numbers and each chain's correlator launches of csrc/."""
    out = {}
    t_phase = time.perf_counter()
    ob = _opticalbar(dev, n, out)
    bathy = _bathy(dev, n, out)
    _bayer(dev, n, out)
    out["cameras_ii_phase_s"] = time.perf_counter() - t_phase
    print(f"[cameras-ii] phase wall {out['cameras_ii_phase_s']:.4f} s on {smi}")
    return out, {"opticalbar_dem": ob["correlate"], "bathy_dem": bathy["correlate"]}


# ---- phase 10: the flood suite --------------------------------------------------

# flood-s1-8192 (a third of an IW swath's width at 10 m), landsat8-4096 (a
# quarter of a scene), worldview-4096, spot-4096 and modis-4800 (one MOD09
# tile); flood_scene.py holds the generators and the truths
FLOOD_N = 8192
FLOOD_TILE = 512
FLOOD_OPT_N = 4096
FLOOD_MODIS_N = 4800
FLOOD_CPU_N = 1024           # card against CPU
FLOOD_SEED = 41              # + 0..4: the S1, Landsat, WorldView, SPOT and MODIS scenes
FLOOD_WATER_HIT = 0.95       # of the water pixels past fs.SHORE_PX from a shore: classed water
FLOOD_LAND_FP = 0.02         # of the land (and cloud) pixels past it: classed water, at most
FLOOD_CPU_SHARE = 0.9999     # class maps card = CPU from one input, at least
FLOOD_CPU_CHAIN_SHARE = 0.999   # the S1 chains' class maps card = CPU (the warp's noise)
FLOOD_WARP_ULPS = 4          # the warp's reverse map card vs CPU, in fp32 ulps of longitude
FLOOD_THRESHOLD_BIN = 400.0 / 255   # the Martinis thresholds card vs CPU, at most
CNET_POINTS = 4096           # build_control_network on stereo-dem's rectified pair


def _flood_call(fn, dev, quiet=False):
    """(result, wall ms) of ``fn()``, synchronised; its printed lines kept
    from the log when ``quiet``."""
    import contextlib
    import io
    _sync(dev)
    t0 = time.perf_counter()
    if quiet:
        with contextlib.redirect_stdout(io.StringIO()):
            res = fn()
    else:
        res = fn()
    _sync(dev)
    return res, (time.perf_counter() - t0) * 1e3


def _flood_step(tag, name, fn, dev, out, key, once=False):
    """One step of a scene's chain again, timed (wall, synchronised; peak
    device memory), then once under the profiler (device ms, launches);
    ``once``: a single run under the profiler gives the wall too."""
    import torch
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if not cuda or not once:
        res, ms = _flood_call(fn, dev, quiet=True)
    dev_ms = launches = None
    if cuda:
        st = {}
        dev_ms, launches = _dem_profile(lambda st: st.update(r=_flood_call(fn, dev, True)), st)
        if once:
            res, ms = st["r"]
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else None
    idle = None if dev_ms is None else 1 - dev_ms / ms
    out.update({f"{key}_{name}_ms": ms, f"{key}_{name}_device_ms": dev_ms,
                f"{key}_{name}_launches": launches, f"{key}_{name}_idle": idle,
                f"{key}_{name}_peak_mib": peak})
    print(f"[time] {tag} {name}: {ms:.4f} ms{' (under the profiler)' if once and cuda else ''}, "
          f"device {dev_ms} ms in {launches} launches, idle share {idle}, peak device memory "
          f"{peak} MiB")
    return res


def _flood_gate(tag, path, shore, out, key, truth=None):
    """The class map at ``path`` against the truth: of the valid pixels
    farther than fs.SHORE_PX from a shore, >= FLOOD_WATER_HIT of the water
    ones classed water and <= FLOOD_LAND_FP of the land ones (cloud ones
    anywhere) classed water."""
    import torch
    from visionworkbench_torch.fileio import read_tiff
    cls = torch.as_tensor(read_tiff(path)[0]).to(shore.device)
    valid = cls != 0
    wet = shore < 0 if truth is None else truth == 1
    water = valid & wet & (shore < -fs.SHORE_PX)
    land = valid & ~wet & (shore > fs.SHORE_PX)
    if truth is not None:
        land |= valid & (truth == 2)
    hit = float((cls[water] == 255).double().mean())
    fp = float((cls[land] == 255).double().mean())
    out.update({f"{key}_water_hit": hit, f"{key}_land_fp": fp})
    print(f"[flood] {tag}: {hit:.6f} of {int(water.sum())} water pixels classed water (gate >= "
          f"{FLOOD_WATER_HIT}), {fp:.6f} of {int(land.sum())} land pixels (gate <= "
          f"{FLOOD_LAND_FP}); {float((cls == 255).double().mean()):.4f} of the map water, "
          f"{float((~valid).double().mean()):.4f} no data")
    if not water.any() or not land.any() or hit < FLOOD_WATER_HIT or fp > FLOOD_LAND_FP:
        raise SystemExit(f"{tag}: the water map fails its gate")


def _flood_s1(dev, n, folder, out):
    """flood-s1-n: the sentinel1_flood_detect chain step by step, each step
    once under the profiler, gated; the tool with the DEM, gated; the
    labelling passes, the Martinis threshold and the tiles kept."""
    import torch
    from visionworkbench_torch.fileio import read_tiff
    from visionworkbench_torch.image import morphology
    from visionworkbench_torch.tools import clean_sentinel1_borders as csb
    from visionworkbench_torch.tools import detect_water as dw
    from visionworkbench_torch.tools import sentinel1_flood_detect as sfd
    from visionworkbench_torch.tools.flood import radar
    tag, key = f"flood-s1-{n}", "flood_s1"
    t0 = time.perf_counter()
    sc = fs.sentinel1(n, FLOOD_SEED, dev, folder)
    dem = fs.s1_dem(sc, n, dev, folder)
    up, shape = fs.north_up(sc["georef"], n)
    shore = fs.s1_truth(sc, up, shape, dev).float()
    _sync(dev)
    out[f"{key}_make_s"] = time.perf_counter() - t0
    print(f"[flood] {tag}: {n}^2 uint16 DN, {sc['nodata_share']:.4f} no data, the warped "
          f"frame {shape[0]}x{shape[1]} ({float((shore < 0).double().mean()):.4f} of it water "
          f"in the truth, with the outside), made and written in {out[f'{key}_make_s']:.2f} s")
    res = os.path.join(folder, "s1_flood.tif")
    clean, ortho = res + "_clean.tif", res + "_WARP.tif"
    tile = ["--tile-size", str(FLOOD_TILE)]
    # the chain, step by step as sentinel1_flood_detect runs it: clean ->
    # north-up warp -> Martinis; then the tool itself with the DEM (clean
    # and warp reused, as the tool does: the chain with the DEM)
    runs = (("clean", lambda: csb.main([sc["path"], "-o", clean], device=dev)),
            ("warp", lambda: sfd.warp_north_up(clean, ortho, dev)),
            ("detect", lambda: dw.main([ortho, "-o", res, "--mode", "sentinel1"] + tile,
                                       device=dev)),
            ("dem_chain", lambda: sfd.main([sc["path"], res, "--dem-path", dem] + tile,
                                           device=dev)))
    for name, fn in runs:
        morphology.label_passes = 0
        _flood_step(tag, name, fn, dev, out, key, once=True)
        if name == "detect":
            ms = sum(out[f"{key}_{k}_ms"] for k in ("clean", "warp", "detect"))
            out.update({f"{key}_chain_ms": ms, f"{key}_chain_mps": n * n / (ms * 1e3)})
            print(f"[time] {tag} chain: {ms:.4f} ms, {n * n / (ms * 1e3):.3f} Mp/s of input")
            _flood_gate(tag, res, shore, out, key)
        if name in ("detect", "dem_chain"):
            out[f"{key}_{name}_label_passes"] = morphology.label_passes
            print(f"[flood] {tag} {name}: {morphology.label_passes} blob-labelling passes "
                  "(raw water 4-connected, then the hysteresis fill 8-connected)")
    _flood_gate(tag + " with the DEM", res, shore, out, key + "_dem")
    # stages 1-4 once more for the tiles kept
    img = torch.as_tensor(read_tiff(ortho)[0]).to(dev)
    proc, pvalid = radar.preprocess_sentinel1(img, img > 0)
    stats = [x.cpu().numpy() for x in radar.generate_tile_means(proc, pvalid, FLOOD_TILE)]
    kept = radar.select_best_tiles(*stats)
    thr = radar.compute_global_threshold(proc, pvalid, kept, FLOOD_TILE)
    out.update({f"{key}_threshold": thr, f"{key}_kept_tiles": kept})
    print(f"[flood] {tag} Martinis: threshold {thr} (preprocessed units) from the tiles "
          f"{kept} of {FLOOD_TILE}")


def _flood_optical(dev, n, modis_n, folder, out):
    """landsat8-n, worldview-n, spot-n: detect_water on the scene's files;
    modis-modis_n: extract_modis, then detect_water --mode modis (evi).
    Each gated, each step timed, each chain's Mp/s."""
    from visionworkbench_torch.tools import detect_water as dw
    from visionworkbench_torch.tools import extract_modis as em
    scenes = (("landsat8", fs.landsat8, n, ["--mode", "landsat"]),
              ("worldview", fs.worldview3, n, ["--mode", "worldview"]),
              ("spot", fs.spot6, n, ["--mode", "spot"]),
              ("modis", fs.modis, modis_n, ["--mode", "modis"]))
    for i, (name, make, size, mode) in enumerate(scenes, 1):
        tag, key = f"{name}-{size}", f"flood_{name}"
        t0 = time.perf_counter()
        sc = make(size, FLOOD_SEED + i, dev, folder)
        _sync(dev)
        print(f"[flood] {tag}: made and written in {time.perf_counter() - t0:.2f} s "
              f"({float((sc['classes'] == 1).double().mean()):.4f} water in the truth)")
        res = os.path.join(folder, f"{name}_water.tif")
        chain = 0.0
        inputs = sc["paths"]
        if name == "modis":
            prefix = os.path.join(folder, "modis_")
            _flood_step(tag, "extract", lambda: em.main(inputs + ["--prefix", prefix,
                                                                  "--overwrite"], device=dev),
                        dev, out, key)
            chain += out[f"{key}_extract_ms"]
            inputs = [prefix + "modis_stack.tif"]
        _flood_step(tag, "detect", lambda: dw.main(inputs + mode + ["-o", res], device=dev),
                    dev, out, key)
        chain += out[f"{key}_detect_ms"]
        out.update({f"{key}_chain_ms": chain, f"{key}_chain_mps": size * size / (chain * 1e3)})
        print(f"[time] {tag} chain: {chain:.4f} ms, {size * size / (chain * 1e3):.3f} Mp/s")
        _flood_gate(tag, res, sc["shore"], out, key, sc["classes"])


def _flood_threshold(text):
    m = re.search(r"sentinel1 global threshold: ([0-9.]+)", text)
    return float(m.group(1))


def _flood_vs_cpu(dev, n, folder, out):
    """The card against the CPU at n^2 (each scene made on the CPU, the same
    files given to both): every chain's class map (the rest of the pixels
    counted) and the Martinis thresholds; the S1 chain's pieces apart:
    Martinis on one warped frame (the CPU chain's; >= FLOOD_CPU_SHARE), and
    the warp's reverse map, whose fp32 lon/lat differ card vs CPU by an ulp
    or two (<= FLOOD_WARP_ULPS), so the S1 chains are held to
    FLOOD_CPU_CHAIN_SHARE."""
    import contextlib
    import io
    import torch
    from visionworkbench_torch.cartography.geotransform import GeoTransform
    from visionworkbench_torch.fileio import read_tiff
    from visionworkbench_torch.image.transform import _dest_grid
    from visionworkbench_torch.tools import detect_water as dw
    from visionworkbench_torch.tools import extract_modis as em
    from visionworkbench_torch.tools import sentinel1_flood_detect as sfd
    src = os.path.join(folder, "cpu_inputs")
    os.makedirs(src)
    s1 = fs.sentinel1(n, FLOOD_SEED, "cpu", src)
    dem = fs.s1_dem(s1, n, "cpu", src)
    scenes = {name: make(n, FLOOD_SEED + i, "cpu", src) for i, (name, make) in enumerate(
        (("landsat8", fs.landsat8), ("worldview", fs.worldview3), ("spot", fs.spot6),
         ("modis", fs.modis)), 1)}
    tile = ["--tile-size", str(FLOOD_TILE)]
    same_input = os.path.join(folder, "vs_cpu_cpu", "s1.tif_WARP.tif")
    maps, thresholds = {}, {}
    devs = list(dict.fromkeys(("cpu", dev)))
    for d in devs:
        f = os.path.join(folder, f"vs_cpu_{torch.device(d).type}")
        os.makedirs(f)
        res = os.path.join(f, "s1.tif")
        runs = (("s1", lambda: sfd.main([s1["path"], res] + tile, device=d)),
                ("s1_dem", lambda: sfd.main([s1["path"], res, "--dem-path", dem] + tile,
                                            device=d)),
                ("s1_same_input", lambda: dw.main([same_input, "-o", res, "--mode",
                                                   "sentinel1"] + tile, device=d)))
        for name, run in runs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if run():
                    raise SystemExit(f"flood vs CPU: {name} failed on {d}")
            thresholds[d, name] = _flood_threshold(buf.getvalue())
            maps[d, name] = read_tiff(res)[0]
        maps[d, "warp"] = read_tiff(res + "_WARP.tif")[0]
        with contextlib.redirect_stdout(io.StringIO()):
            for name, sc in scenes.items():
                inputs = sc["paths"]
                if name == "modis":
                    em.main(inputs + ["--prefix", os.path.join(f, "modis_")], device=d)
                    inputs = [os.path.join(f, "modis_modis_stack.tif")]
                res = os.path.join(f, f"{name}.tif")
                if dw.main(inputs + ["--mode", name.rstrip("8"), "-o", res], device=d):
                    raise SystemExit(f"flood vs CPU: detect_water {name} failed on {d}")
                maps[d, name] = read_tiff(res)[0]
    failed = []
    for name in ("s1", "s1_dem", "s1_same_input", "landsat8", "worldview", "spot", "modis"):
        card, cpu = maps[dev, name], maps["cpu", name]
        share = float((card == cpu).mean()) if card.shape == cpu.shape else 0.0
        bound = FLOOD_CPU_CHAIN_SHARE if name in ("s1", "s1_dem") else FLOOD_CPU_SHARE
        out[f"flood_cpu_{name}_share"] = share
        msg = (f"[flood] card vs CPU {name}-{n}: class maps equal on {share:.6f} of the pixels "
               f"({int((card != cpu).sum())} differ; gate >= {bound})")
        if name.startswith("s1"):
            dt = abs(thresholds[dev, name] - thresholds["cpu", name])
            out[f"flood_cpu_{name}_threshold_diff"] = dt
            msg += (f", thresholds {thresholds[dev, name]:.4f} / {thresholds['cpu', name]:.4f} "
                    f"(bound {FLOOD_THRESHOLD_BIN:.4f})")
            if dt > FLOOD_THRESHOLD_BIN:
                failed.append(f"{name} thresholds")
        print(msg)
        if share < bound:
            failed.append(f"{name} class maps")
    # the warp: its reverse map (fp32 through lon/lat, as the JAX package's;
    # bounded in fp32 ulps of the scene's longitude) and the warped planes
    up, shape = fs.north_up(s1["georef"], n)
    tx = GeoTransform(s1["georef"], up)
    grids = {d: [g.cpu().double() for g in tx.reverse(*_dest_grid(shape[0], shape[1], d))]
             for d in devs}
    coord = max(float((a - b).abs().max()) for a, b in zip(grids[dev], grids["cpu"]))
    lon, lat = (float(v) for v in s1["georef"].pixel_to_lonlat(n / 2, n / 2))
    ulp_px = (float(np.spacing(np.float32(abs(lon)))) * np.pi / 180 * 6378137.0
              * np.cos(np.radians(lat)) / fs.S1_PIXEL_M)
    warp = np.abs(maps[dev, "warp"].astype(np.float64) - maps["cpu", "warp"])
    out.update(flood_cpu_warp_coord_px=coord, flood_cpu_warp_coord_ulps=coord / ulp_px,
               flood_cpu_warp_equal=float((warp == 0).mean()),
               flood_cpu_warp_max_dn=float(warp.max()))
    ulps = coord / ulp_px
    print(f"[flood] card vs CPU s1 warp: reverse map {coord:.4e} px apart at most ({ulps:.2f} "
          f"fp32 ulps of longitude at ({lon:.3f}, {lat:.3f}): {ulp_px:.4f} px; "
          f"bound {FLOOD_WARP_ULPS}); warped planes equal on {float((warp == 0).mean()):.6f} "
          f"of the pixels, {warp.max():.4f} DN apart at most")
    if coord > FLOOD_WARP_ULPS * ulp_px:
        failed.append("the warp's reverse map")
    if failed:
        raise SystemExit(f"flood vs CPU: {', '.join(failed)} differ beyond their bounds")


def _cnet_vs_cpu(dev, out, m=CNET_POINTS):
    """``build_control_network`` on stereo-dem's rectified pair (a third
    camera 30 m on, so a third of the points chain across three images):
    the card's network equal to the CPU's, >= 0.99 of the points kept, each
    within DEM_POINT_M of the float64 oracle; timed on the card."""
    import torch
    from visionworkbench_torch.ba import build_control_network
    from visionworkbench_torch.camera import PinholeModel
    left, right = sds.rectify(sds.scene(sds.DEM_N))
    third = PinholeModel(np.float32(2 * right.C - left.C).astype(np.float64), right.R,
                         (right.fu, right.fv), (right.cu, right.cv))
    cams = [left, right, third]
    centre = 0.5 * (left.C + right.C)
    rng = np.random.default_rng(FLOOD_SEED)
    ground = (centre - centre / np.linalg.norm(centre) * rng.uniform(900, 1100, (m, 1))
              + rng.normal(0, 150, (m, 3)))
    pix = [sds.project64(c, ground) for c in cams]
    k = 2 * m // 3
    matches = {(0, 1): (pix[0][:k], pix[1][:k]), (1, 2): (pix[1][m // 3:], pix[2][m // 3:])}
    nets = {}
    for d in dict.fromkeys(("cpu", dev)):
        nets[d], ms = _flood_call(lambda: build_control_network(["l", "r", "t"], cams, matches,
                                                                device=d), d)
    card, cpu = nets[dev], nets["cpu"]
    pos = np.stack([p.position for p in card.points])
    same = (len(card) == len(cpu) and np.array_equal(pos, np.stack([p.position for p in cpu.points]))
            and [[(q.image_id, q.col, q.row) for q in p.measures] for p in card.points]
            == [[(q.image_id, q.col, q.row) for q in p.measures] for p in cpu.points])
    oracle = np.stack([sds.triangulate64(cams[p.measures[0].image_id],
                                         cams[p.measures[1].image_id],
                                         np.array(p.measures[0].position()),
                                         np.array(p.measures[1].position()))
                       for p in card.points])
    err = float(np.linalg.norm(pos - oracle, axis=-1).max())
    out.update(cnet_points=len(card), cnet_measures=card.num_measures(), cnet_ms=ms,
               cnet_err_m=err)
    print(f"[flood] build_control_network on stereo-dem's pair and a third camera: {len(card)} "
          f"points, {card.num_measures()} measures, card = CPU {same}, {ms:.4f} ms on {dev}, "
          f"{err:.4f} m from float64 at most (bound {sds.DEM_POINT_M})")
    # (union-find on 1/8-px keys may merge two points whose pixels round alike)
    if not same or len(card) < 0.99 * m or err > sds.DEM_POINT_M:
        raise SystemExit("build_control_network: the card and the CPU disagree, or points "
                         "are missing or off")


def phase_flood(dev, smi, n=FLOOD_N, opt_n=FLOOD_OPT_N, modis_n=FLOOD_MODIS_N,
                cpu_n=FLOOD_CPU_N):
    """flood-s1-n, landsat8-, worldview-, spot-opt_n and modis-modis_n, the
    card against the CPU at cpu_n^2 and build_control_network (see the
    module docstring, phase 10). Returns the ``flood_*`` and ``cnet_*``
    numbers."""
    out = {}
    t_phase = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="chip_smoke_flood_")
    try:
        _reset_counts()
        _flood_s1(dev, n, folder, out)
        _flood_optical(dev, opt_n, modis_n, folder, out)
        _flood_vs_cpu(dev, cpu_n, folder, out)
        _cnet_vs_cpu(dev, out)
        _sync(dev)
        if any(_read_counts().values()):
            raise SystemExit(f"flood: launched kernels of csrc/ {_read_counts()}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    out["flood_phase_s"] = time.perf_counter() - t_phase
    print(f"[flood] phase wall {out['flood_phase_s']:.4f} s on {smi}")
    return out


def _kernel_name(name):
    """``band_sweep_kernel<0, 24>`` of a profiler's kernel signature."""
    m = re.search(r"\w+_kernel<[^>]*>", name)
    return m.group(0) if m else name[:40]


def _is_sweep(name):
    """A kernel of csrc/sweep.cu: sweep_kernel or a band kernel."""
    return "sweep_kernel" in name or "band_census_kernel" in name


def _row(ms, plain_ms, nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import visionworkbench_torch  # noqa: F401  (fails when run without the repo)
    if sys.argv[1:2] == ["--parallel-rank"]:
        return _parallel_rank(*sys.argv[2:6])
    dev = "cuda"
    phase_build()
    smi = _smi()
    print(smi)
    err = phase_kernels(dev)
    counts = phase_main(dev)
    phase_slice_vs_cpu(dev)
    frame, rows = phase_timings(dev)
    par_counts, par_frame = phase_parallel(dev, smi)
    host_io = phase_host_io(dev)
    stereo_dem, dem_launches = phase_stereo_dem(dev, smi)
    cameras_ii, cam_launches = phase_cameras_ii(dev, smi)
    flood = phase_flood(dev, smi)
    # kernel: (heaviest main-path shape, main-path run, source, TPU kernel)
    sweep_cu = "visionworkbench_torch/csrc/sweep.cu"
    sweep_tpu = "visionworkbench_tpu/ops/sweep.py:603"
    table = {
        "sweep": ("level0_patches", "plain", sweep_cu, sweep_tpu),
        "sweep_cli": ("cli_level0", "cli_log", sweep_cu, sweep_tpu),
        "sweep_census": ("level0_patches", "config4", sweep_cu, sweep_tpu),
        "sweep_ternary_census": ("level0_patches", "config4_ternary7", sweep_cu, sweep_tpu),
        "sweep_ncc": ("config3", "calc3_ncc", sweep_cu, sweep_tpu),
        "sweep_census_codes": ("config3", "calc3_census7", sweep_cu, sweep_tpu),
        "best_of_search": ("config3", "k6_best_of_search", sweep_cu,
                           "visionworkbench_tpu/ops/cost_volume.py:165"),
        "tiled_search": ("config3_tiles", "k7_tiled_search", sweep_cu,
                         "visionworkbench_tpu/ops/cost_volume.py:332"),
        "speckle": ("1024x1024_11x11", "plain", "visionworkbench_torch/csrc/speckle.cu",
                    "visionworkbench_tpu/ops/speckle.py:93"),
        "scan_bidir": ("level0_x", "sgm", "visionworkbench_torch/csrc/mgm_scan.cu",
                       "visionworkbench_tpu/ops/sgm_scan.py:149"),
        "scan_bidir_path_scan": ("calc_x", "calc_sgm",
                                 "visionworkbench_torch/csrc/sgm_path_scan.cu",
                                 "visionworkbench_tpu/ops/sgm_scan.py:149"),
        "mgm_bidir": ("level0", "mgm", "visionworkbench_torch/csrc/mgm_scan.cu",
                      "visionworkbench_tpu/ops/sgm_scan.py:222"),
        "mgm_fwd": ("level0_sheared", "mgm", "visionworkbench_torch/csrc/mgm_scan.cu",
                    "visionworkbench_tpu/ops/sgm_scan.py:272"),
        "mgm_bidir_cluster": ("calc", "calc_mgm",
                              "visionworkbench_torch/csrc/mgm_cluster_scan.cu",
                              "visionworkbench_tpu/ops/sgm_scan.py:222"),
        "mgm_fwd_cluster": ("calc_sheared", "calc_mgm",
                            "visionworkbench_torch/csrc/mgm_cluster_scan.cu",
                            "visionworkbench_tpu/ops/sgm_scan.py:272"),
        "mgm_bidir_lane_cluster": ("level0_1024", "mgm_1024",
                                   "visionworkbench_torch/csrc/mgm_scan.cu",
                                   "visionworkbench_tpu/ops/sgm_scan.py:222"),
        "mgm_fwd_lane_cluster": ("level0_sheared_1024", "mgm_1024",
                                 "visionworkbench_torch/csrc/mgm_scan.cu",
                                 "visionworkbench_tpu/ops/sgm_scan.py:272"),
        # the JAX package runs this step as tensor work: no TPU kernel
        "sgm_wta": ("mgm_level0_1536", "mgm", "visionworkbench_torch/csrc/sgm_wta.cu", None),
    }
    kernels = []
    for k, (shape, run, source, replaces) in table.items():
        c = counts[run]
        if k == "scan_bidir_path_scan":
            r = rows[("scan_bidir", shape)]
            launches = c["scan_bidir/path_scan"]
        elif k.endswith("_cluster"):
            # in each run only one layout goes a cluster a line
            wrapper = k.split("_")[0] + "_" + k.split("_")[1]
            r = rows[(wrapper, shape)]
            launches = c[f"{wrapper}/cluster_scan"]
        else:
            r = rows[(k, shape)]
            # the scans: launches of the register-carry kernel on the path
            launches = (c[f"{k}/mgm_scan"] if f"{k}/mgm_scan" in c
                        else c[k if k in c else "sweep"])
        # launches per config-7 frame and per cli-match correlation of the
        # kernels their paths run
        c7 = {"sweep_census": "sweep", "speckle": "speckle"}.get(k)
        cm = {"sweep_cli": "sweep", "speckle": "speckle"}.get(k)
        # launches per frame of the parallel phase's run of the kernel
        pk = {"sweep": ("hier_bm", "sweep"), "speckle": ("hier_bm", "speckle"),
              "scan_bidir": ("hier_sgm", "scan_bidir/mgm_scan"),
              "mgm_bidir": ("hier_mgm", "mgm_bidir/mgm_scan"),
              "mgm_fwd": ("hier_mgm", "mgm_fwd/mgm_scan"),
              "best_of_search": ("disp_search", "sweep"),
              "sgm_wta": ("hier_mgm", "sgm_wta")}.get(k)
        # launches of the correlator step of stereo-dem-1024 (phase 8) and of
        # opticalbar-dem-1024 and bathy-dem-1024 (phase 9)
        sd = {"sweep": "sweep/band", "speckle": "speckle"}.get(k)
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            **({"config7_launches": counts["config7_em"][c7]} if c7 else {}),
            **({"cli_match_launches": counts["cli_match"][cm]} if cm else {}),
            **({"calc_launches": counts["calc_mgm"]["sgm_wta"]} if k == "sgm_wta" else {}),
            **({"parallel_run": pk[0], "parallel_launches": par_counts[pk[0]][pk[1]]}
               if pk else {}),
            **({"stereo_dem_launches": dem_launches.get(sd, 0),
                **{f"{c}_launches": cam_launches[c].get(sd, 0) for c in cam_launches}}
               if sd else {}),
            "max_abs_err": err[k], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "shape": shape,
            **{x: r[x] for x in ("us_per_step", "line_scan_ms", "device_ms",
                                 "sweep_kernel_ms", "sweep_kernel_device_ms", "lines_ms",
                                 "lanes_ms", "distinct_ms", "none_ms")
               if x in r}})
    print(json.dumps({"frame_ms": frame["plain"]["ms"],
                      "frame_mps": frame["plain"]["mps"],
                      "frame_lr_ms": frame["consistency"]["ms"],
                      "sgm_frame_ms": frame["sgm"]["ms"],
                      "sgm_frame_mps": frame["sgm"]["mps"],
                      "mgm_frame_ms": frame["mgm"]["ms"],
                      "mgm_frame_mps": frame["mgm"]["mps"],
                      "calc_sgm_frame_ms": frame["calc_sgm"]["ms"],
                      "calc_mgm_frame_ms": frame["calc_mgm"]["ms"],
                      "mgm_1024_frame_ms": frame["mgm_1024"]["ms"],
                      **{f"{k}_frame_ms": frame[k]["ms"] for k in
                         ("config4", "config4_lr", "ncc", "ncc_lr", "calc3_abs",
                          "calc3_ncc", "calc3_census7", "cli_log", "cli_log_parabola")},
                      "cli_log_frame_mps": frame["cli_log"]["mps"],
                      **{f"cli_log_{k}": frame["cli_log"][k] for k in
                         ("device_ms", "launches", "prefilter_device_ms",
                          "prefilter_launches", "prefilter_share", "blob_passes",
                          "blob_ms", "snake_passes", "snake_ms")},
                      **{f"{what}_{k}": v for what in ("config7_em", "config7_affine",
                                                       "cli_em", "config5", "config1",
                                                       "config2", "cli_match", "config8")
                         for k, v in frame[what].items()},
                      **{f"ipfind_{op}_{k}": v for op, r in counts["sift_chains"].items()
                         for k, v in r.items()},
                      **{f"parallel_{what}_{k}": v for what, r in par_frame.items()
                         for k, v in r.items()},
                      **host_io,
                      **stereo_dem,
                      **cameras_ii,
                      **flood,
                      "card": smi}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
