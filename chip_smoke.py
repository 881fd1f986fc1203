"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each printing one line; any failure exits non-zero:

1. environment: the card (name, power limit), torch and CUDA versions, TF32
   off for convolutions and matrix products (the port's forwards turn it
   off for themselves too);
2. build: both CUDA sources of ``keras_ocr_tpu_torch/csrc`` (the sweep
   kernel and the conv kernel), started together, each with its time; the
   sweep kernel's part of phase 3 runs while the conv kernel builds;
3. kernel vs plain: both entries of the sweep kernel (the label sweeps and
   the keyed row/column runs of the blob census) against their plain
   PyTorch versions on the card, on seeded masks (densities 0.3-0.8 plus a
   serpentine that needs more than 8 sweeps) at (4, 256, 320) and
   (8, 480, 640); maps and converged flags must be exactly equal; median
   times of 20 runs, with the bytes a full pass moves and the HBM bound of
   the bytes this data needs (each image stops at its fixpoint, and a pass
   writes only what it changes) and the share of it.
   The same on the calls one ``get_boxes`` makes on the golden artifact's
   own heatmaps (its first 8 scenes), recorded as the main path makes
   them. Then the conv kernel: ``conv_chain`` on the 12 conv
   chains of a full-width CRAFT at 960x1280, batch 1, and
   ``conv3x3_bias_act`` at C3 and at an odd size, against ``F.conv2d``
   (cuDNN, TF32 off) within 1e-4 * max(1, max|plain|), median of 20 each,
   with each chain's rate as a share of the kernel's 3xTF32 ceiling and
   the Cout tile each layer took, and one ``F.conv2d`` as the library
   yardstick of ``conv3x3_bias_act``;
4. golden: the committed trained slim pipeline
   (``tests/fixtures/golden_offline``) must read at least the artifact's
   ``pass_fraction`` of its expected words;
5. full width: ``Detector(width=1.0)`` and the default ``Recognizer``
   (filters 64..512, STN) on seeded random weights, ``Pipeline(scale=2)``
   on the golden scenes padded to 640x480, through ``recognize`` and
   ``recognize_many(batch_size=8)``; the output must be well formed with
   finite boxes, the device program must enqueue without a host
   synchronisation, and the pipeline phases must have launched both sweep
   kernel entries;
6. golden, folded: the same artifact through ``Detector(fold_bn=True)``,
   its standard checkpoint folded on load, must pass too, with both conv
   wrappers launched;
7. full width, folded: the full-width detector with seeded BatchNorm
   statistics, folded into ``Detector(fold_bn=True)``; its heatmaps must
   agree with the unfolded cuDNN graph within 1e-3 * max(1, max|ref|);
   ``recognize`` and ``recognize_many`` of both graphs, the folded device
   program under sync debug mode "error", and the CRAFT forward of both
   graphs at batch 1 and 8.

8. refine: (8, 480, 640, 2) heatmaps of seeded split words (whose dilated
   segmaps fall into several blobs), a blob nested in a ring's hole, and one
   word wider than 512 columns that fails the first refine level.
   ``get_boxes`` + ``refine_boxes`` at each level of ``ops.refine.LADDER``
   on the card, every sweep-kernel call held exact against its plain
   version on the same tensors (the window batches of the labelling and the
   flood); level 1 also against the whole CPU run (``refine_ok`` and
   ``n_flagged`` exact, boxes within 1e-3 px), levels 2 and 3 against
   level 1's boxes of the images both prove; per level the host enqueue
   and event ms (medians of 3), the device busy ms and the sweep kernel's
   part (``torch.profiler``) and the sweep-kernel launches. ``Detector.detect``
   with CRAFT replaced by those heatmaps must take no host fallback and
   agree with the host oracle ``getBoxes`` within 3 px; the full-width
   ``Detector.detect`` runs on 8 scenes; the full-width pipeline on the
   stand-in heatmaps must escalate the refine ladder, end with flag 2
   clear, and enqueue at refine levels 1-3 without a host synchronisation.

9. two-stage: the golden artifact through ``recognize(...,
   recognition_kwargs={"verbose": 0})`` (host resize, ``Detector.detect``,
   host ``warpBox`` crops, the CRNN), standard and folded: its word fraction
   and ``evaluation.score`` against the fused path's results must reach
   ``pass_fraction``, both sweep-kernel entries must launch, and both conv
   entries on the folded graph; the full-width CRNN's softmax on the card
   within 1e-4 of the CPU on the slim detector's crops; the full-width
   two-stage ``recognize`` p50 beside the fused one, and its stage split
   (host resize, ``detect``, host crops, CRNN + CTC).

10. serving: ``tests/fixtures/test_image.jpg`` read by path with the port's
   JPEG decoder (its sha256 must be that of PIL's decode, which
   ``tests/test_torch_tools.py`` asserts too; median decode ms beside the
   host's CPU model), and the full-width ``recognize`` of that path; the
   golden pipeline, standard and folded, exported on the card at its
   ``pad_to`` envelope (batch 4), loaded with ``load_exported`` and served
   the 12 scenes through ``ExportedPipeline.recognize``: the word fraction
   must reach ``pass_fraction``, every packed output must equal the live
   device program's at the baked levels, and the kernels must launch inside
   the artifact's run (counted from zero); then the full-width pipeline
   exported at 640x480, batch 1 and 8, with its export, save and load
   seconds, ``.pt2`` size and graph nodes, and the artifact's ``recognize``
   p50 timed in turns with the live one's.

11. training: the full-width CRNN (``DEFAULT_BUILD_PARAMS``, dropout 0) at
   batch 8 and CRAFT (width 1.0) at 2x256x256 take one train step on the
   card and the same step on the CPU from the same state, in float32 and in
   float64: the float32 losses within 1e-4 relative; each float64 gradient
   leaf within 1e-3 of its largest |g| (leaves at rounding noise within
   1e-4 of the model's largest), the worst leaf printed, and the float32
   gradients' distance from the float64 ones on the card and the CPU; 20
   steps on a fixed batch must lower each loss; an OHEM step must give a
   finite loss. Times (CUDA events, medians of 10): CRNN steps
   at batch 8 and 64, CRAFT steps at 640x640 batch 8 on
   ``get_batch_generator`` batches of numpy-drawn character lines, with the
   peak memory and the host ms of one generator batch; the port's
   ``ctc_loss`` forward + backward against ``F.ctc_loss`` at batch 64.
   ``fit`` for 2 epochs x 2 steps with ``EarlyStopping``,
   ``ModelCheckpoint`` and ``CSVLogger``, then ``save_npz`` (in
   ``build/training``, removed at the end); the trained detector's
   ``Detector.detect`` of a golden scene must launch both sweep-kernel
   entries. The train step launches none of the three kernels.

12. weights: the full-width CRAFT (seeded BatchNorm statistics) written by
   the port's writers as ``.h5``, ``.pth`` and a legacy-format ``.pth`` in
   clovaai's form (``module.`` keys, no ``num_batches_tracked``), and the
   full-width CRNN (STN) as top and notop ``.h5``, under ``build/weights``
   (removed at the end). Each file resolves through ``download_pretrained``
   from that directory with ``urllib.request.urlopen`` refused (any call
   fails the phase), reads back bit for bit, and loads by name
   (``Detector(load_from_torch=...)``, standard and ``fold_bn=True``;
   ``Recognizer()``): heatmaps at 480x640 and softmax on 8 crops identical
   to models given the same tree; ``Recognizer(alphabet="abcdefghij")``
   takes the notop backbone and keeps its own ``fc_12``. The ``.pth``-loaded
   detectors' full-width ``recognize`` of 4 golden scenes at 640x480 must
   launch both sweep-kernel entries, and the folded one both conv entries.
   The torch twin from the ``.pth`` within 1e-4 * max(1, max|ref|) of the
   port's CRAFT at 480x640. Then file MB, write, read+convert and
   construction seconds (medians of 3) and the HDF5 reader's MB/s; and, if
   ``weights_pretrained/`` holds the published ``craft_mlt_25k.h5`` and
   ``crnn_kurapan.h5`` with the registry's sha256, ``Pipeline()`` reads
   ``tests/fixtures/test_image.jpg``; else one line names the missing files.

13. efficientnet: ``Detector(weights=None, backbone_name="efficientnetb0")``
   with ``urlopen`` refused (the ImageNet file is not vendored, so it warns
   and keeps a random backbone; seeded BatchNorm statistics), in
   ``Pipeline(scale=2)`` on the golden scenes padded to 640x480 through
   ``recognize`` and ``recognize_many(batch_size=8)``: well-formed results,
   the device program enqueued without a host synchronisation, both
   sweep-kernel entries launched (counted from zero); ``Detector.detect`` of
   8 scenes at thresholds set by quantiles of its own random heatmaps, held
   to the CPU run of the device path on 2 of them (1e-3 px) and to the host
   oracle ``getBoxes`` in box count (its distance printed: the noise blobs'
   rectangles part from the oracle's by more than phase 8's 3 px); the
   CRAFT forward of B0, B3 and
   B7 beside the VGG graph's at 960x1280, batch 1 and 8 (CUDA events,
   median of 10, peak memory), and the VGG and B0 forwards at every batch
   1-8 (medians of 5 between), each row printed whole: no batch may take
   more than 2x batch 1's time per image; the B0 train step on the card against the
   CPU (as phase 11) and three ``DetectorTrainer`` steps at 640x640, batch
   8, whose loss must fall, with step ms and peak memory; and, if
   ``weights_pretrained/efficientnetb0_notop.h5`` is there, its taps.

14. data: the committed ``tests/fixtures/progressive.jpg`` and
   ``interlaced.png`` read with the port's ``tools.read`` must decode to the
   sha256 of PIL's decode, with the median decode ms of both beside the
   baseline ``test_image.jpg``'s; with ``urllib.request.urlopen`` refused
   for the whole phase (any call fails it), an offline cache under
   ``build/data`` (removed at the end) in the layouts the loaders take:
   229 ICDAR 2013 images (the baseline and the progressive JPEG in turn,
   hard-linked) with GT files of seeded words inside each image, and 3567
   BornDigital crops (the interlaced PNG) with their ``gt.txt``;
   ``get_icdar_2013_detector_dataset`` -> ``get_detector_image_generator``
   (``Affine``, ``GaussianBlur``, ``Multiply``; 640x640) ->
   ``Detector.get_batch_generator(8)`` -> ``DetectorTrainer.fit`` of three
   steps on the full-width VGG CRAFT, and
   ``get_born_digital_recognizer_dataset`` ->
   ``get_recognizer_image_generator`` -> ``Recognizer.get_batch_generator(8)``
   -> ``RecognizerTrainer.fit`` of three steps on the full-width CRNN:
   finite losses, each batch's host ms split into ``read``, ``augment``,
   ``compute_maps`` and the rest, beside the step ms (CUDA events), and
   each ``fit``'s wall ms beside the device's busy ms in it
   (``torch.profiler``) and the idle share; then the data-trained
   detector's ``Detector.detect`` of the progressive fixture, at thresholds
   set by quantiles of its heatmaps, must launch both sweep-kernel entries
   (counted from zero), each call equal to its plain version on the same
   tensors, and find boxes within 1e-3 px of the CPU run of the device path
   on the card's heatmaps.

15. bfloat16: the conv kernel's bf16 mode (the persistent kernel) against
   its plain bf16 version (float32 conv of the bf16-rounded operands, one
   rounding per layer) on the 12 CRAFT chains at 960x1280 and
   ``conv3x3_bias_act`` at C3 and at an odd size: a single layer within one
   bf16 ulp, a chain within 1.6e-2 * max(1, max|plain|) with 99% of its
   values within one ulp; each call's median of 20 by CUDA events beside
   its conv kernel's device time from ``torch.profiler`` (where it saw
   every launch) and the call's device time replayed from a CUDA graph,
   and each layer's Cout tile, the rate as a share of the 989 TFLOP/s dense
   bf16 rate, beside phase 3's float32 mode; C3's layer against a cuDNN
   bf16 ``F.conv2d`` with bias, as a speed ratio (this part runs right
   after phase 3, so that its profiler sessions are the process's first).
   The golden
   artifact through ``load_golden_pipeline(dir, torch.bfloat16)``, standard
   and folded, must reach ``pass_fraction``, the scenes whose words differ
   from the float32 run printed (its export is a card test); the
   full-width pipelines in bfloat16 (the float32 run's weights; standard
   and folded): enqueued without a host synchronisation, ``recognize`` p50
   and ``recognize_many`` images/s beside float32's, the peak memory of a
   ``recognize_many`` above the resident models for both dtypes, with the
   bf16 mode's launches counted from zero; the bf16 CRAFT forwards (VGG,
   folded VGG, B0) at 960x1280, batch 1 and 8, failing past 2x batch 1's
   time per image; and the graft entry's configuration
   (``__graft_entry__.py``: max_components 64, max_words 32, digits +
   lowercase, one 256x256 float image) through the port's device program,
   whose packed output must be well formed.

16. mesh: the native host-ops library (``keras_ocr_tpu_torch/native.py``)
   must build; the host oracle ``getBoxes`` on two refine-phase heatmaps
   must give identical boxes with the library (its calls counted) and with
   it disabled. The full-width standard and folded pipelines (one word
   bucket of 64) on ``parallel.create_mesh()`` (the one card) and on two
   replicas of it (``devices=[cuda:0, cuda:0]``): ``recognize_many`` of 16
   scenes at batch 8 must read the words of the same models without a mesh
   exactly, boxes within 1e-4 (the two-replica mesh against batch 4, its
   shard's size), every sweep-kernel call of the replicas equal to its
   plain version, each kernel of the path launched; images/s of the three in
   turns (2 rounds). One full-width CRNN step (batch 8, dropout 0) and one CRAFT step
   (640x640, batch 8) from one state on each mesh must equal the step
   without a mesh in float64 (loss within 1e-4 relative, every parameter
   and BatchNorm statistic within 1e-4 * max(1, max|ref|)); the float32
   step ms of the three.

17. bfloat16 training: the full-width CRNN (dropout 0) at batch 8 and
   CRAFT (width 1.0) at 2x256x256 built with ``compute_dtype=bfloat16``
   (float32 parameters) take one train step on the card and the same step
   on the CPU from one state, held to the CPU tests' bars
   (``tests/test_torch_train_bf16.py``: each gradient leaf within 0.5 in
   relative L2, leaves zero in exact arithmetic, read off the CPU's
   float32 step, below 3.3e-2 of the largest |g|, running statistics within
   6.8e-3, the loss within 1e-3 relative), and one bf16 step on
   ``create_mesh()`` and on two replicas of the card (the CRNN at batch 8,
   CRAFT at 2x256x256) against the step without a mesh, to the same bars;
   float32 and bf16 train steps in turns (CUDA events, median of 10, B0 of
   3): the CRNN at batch 8 and 64, the VGG and B0 CRAFT at 640x640 batch 8,
   with the peak memory above the resident model, beside phase 11's
   float32 steps; three ``fit`` steps of each bf16 model (``compile()``) on
   one batch must lower the loss; the bf16-trained VGG CRAFT folded
   (``fold_bn_state_dict``) into ``Detector(fold_bn=True,
   compute_dtype=bfloat16)``: its heatmaps of 2 scenes beside the standard
   bf16 graph's, and ``recognize_many`` of 8 scenes with the bf16-trained
   CRNN, every conv chain held to phase 15's bars of the plain bf16 chain
   and every sweep call equal to its plain version, the conv kernel's bf16
   mode and both sweep entries launched (counted from zero). No CPU
   carry-on: a failure fails the run.

18. spatial sharding: the full-width pipelines, standard float32, folded
   float32 and folded bf16 (the float32 run's folded weights), on meshes
   whose ``model`` axis cuts CRAFT's input into row strips of the one
   card (``create_mesh((1, 2))`` and ``((1, 4))`` on ``[cuda:0] * n``, and
   ``create_hybrid_mesh(2, (1, 2))``: two data positions of two strips),
   against the same models without a mesh: the strip forward's heatmaps
   of 2 scenes (960x1280) within 1e-4 x max(1, max|ref|) of the whole
   forward in float32, within 8e-3 x max(1, max|ref|) and a mean of 1e-3
   in bf16 (PERF.md §2); ``recognize_many`` of 8 scenes at batch 8 with
   every conv chain held to its plain version (phase 3's bar, phase 15's
   in bf16) and every sweep call equal to its plain version, the words
   equal and boxes within 1e-4, every kernel of the path launched
   (counted from zero); ``recognize_many`` images/s (median of 2 rounds,
   no mesh and the three meshes in turns) and the first round's peak
   memory above the models; the folded graphs' CRAFT forward at
   960x1280, batch 1 and 8, without strips and on 2 and 4 (CUDA events,
   median of 5). Then the same for the EfficientNet-B0 CRAFT in float32
   and bfloat16 (``Detector(weights=None, backbone_name="efficientnetb0")``
   with the network refused, seeded BatchNorm statistics, the bf16 graph
   on the float32 one's weights): heatmaps at the same bars, every pixel
   text and no link for the checked ``recognize_many`` (one box an image,
   so that heatmaps within the bars give the same boxes), its sweep calls
   held to their plain versions and counted, the timed rounds at the
   default thresholds, the float32 forwards with the strip forward's
   meetings; and one EfficientNet-B7 heatmap check at batch 1 on 2
   strips, whose deeper stages meet most often;
19. synthetic data: the sha256 of the default font's render of one fixed
   string equal to the CPU test's (numpy rasterises bit for bit on both
   machines); the default font written to a ``.ttf`` as the only font
   group of ``get_image_generator`` at keras-ocr's end-to-end training
   example settings (640x640, font sizes 60-120, margin 50, X/Y tilts of
   +-0.05 degrees, +-15 degrees about Z) on the golden scenes and the
   fixture JPEG as backgrounds: host ms per scene (median of 16) and the
   glyph cache's hit share; ``Detector.get_batch_generator`` (batch 4)
   into three ``DetectorTrainer`` steps and
   ``convert_image_generator_to_recognizer_input`` ->
   ``Recognizer.get_batch_generator`` (batch 8) into three
   ``RecognizerTrainer`` steps, each with its step and generator ms and
   finite losses; then the synthetic-trained detector folded
   (``Detector(fold_bn=True)``) with the trained CRNN in ``Pipeline`` over 4
   generated scenes, every conv chain and sweep call held to its plain
   version and the launches counted from zero.
20. codecs: the GIF fixtures of ``tests/fixtures/gif`` (written by
   ``scripts/make_gif_fixtures.py``) read with ``tools.read`` must decode
   to the sha256 of PIL's decode (``hashes.json``), and each, written by
   the ICDAR 2019 loader's JPEG encoder, to PIL's file byte for byte (else
   to its pixels, decoded by the port; the line says which); a 640x480
   GIF's decode MB/s and the encoder's ms per megapixel (medians of 5);
   ``get_icdar_2019_semisupervised_dataset`` on a cache of the fixtures
   under ``build/icdar2019_cache`` (removed), ``urlopen`` refused: every
   GIF converted to PIL's ``.jpg`` bytes and removed.
21. distributed: two processes spawned with ``torch.multiprocessing``,
   one ``gloo`` group, both on cuda:0, each running 3 full-width CRNN
   steps (batch 8) and 3 VGG CRAFT steps (640x640, batch 4) in float32 and
   in bf16 on ``create_hybrid_mesh(2, (1, 1))`` (``slice`` across the
   processes), from one state: the ranks' losses and parameters bit for
   bit equal, and against the same steps on the one-process mesh of two
   replicas of the card the losses within 1e-4 relative and the
   parameters within 1e-4 * max(1, max|ref|), both under deterministic
   algorithms (the reference in this process, whose cuBLAS workspace is
   fixed at the start); step ms of both; a rank's failure fails the
   phase, and both are killed at a timeout. Rank 0's float32 checkpoints, restored here, the
   CRAFT folded on load, through ``Pipeline.recognize`` of 4 golden scenes
   with every conv chain and sweep call held to its plain version.
22. image formats: every fixture of ``tests/fixtures/images`` (TIFF with
   CCITT Group 3 / 4, LZW, Deflate, PackBits and JPEG; BMP; PNM; CMYK and
   YCCK JPEG; written by ``scripts/make_image_fixtures.py``) read with
   ``tools.read`` must decode to the sha256 of PIL's decode
   (``hashes.json``); host decode ms and MB/s of RGB out of the 2550x3300
   Group 4 page and of a 640x480 LZW RGB TIFF (median of 5); the
   full-width folded pipeline's ``recognize`` of the page by path must
   equal that of its decoded array, with the decode's share of the call; the 12 golden scenes written as PPM, 24-bit BMP and
   uncompressed TIFF by the numpy writers here (``write_ppm``,
   ``write_bmp24``, ``write_tiff_rgb``) read by path through the golden
   folded pipeline must reach ``pass_fraction`` with the PNG run's words.
23. webp: every fixture of ``tests/fixtures/webp`` (lossy with the simple
   filter, 8 partitions, 1 and 4 segments, sharpness 0 and 7, filter
   strength 0 and 100; ``ALPH`` of both compressions and every filter; an
   animation's first frame at an offset; lossless files; written by
   ``scripts/make_webp_fixtures.py``) read with ``tools.read`` must decode
   to the sha256 of PIL's decode; host decode ms and MB/s of RGB out of
   the 12 golden scenes as lossy WebP (quality 80) and of scene 3 as
   lossless WebP (median of 3); the golden folded pipeline reads the 12
   lossy scenes by path: its words and boxes must equal those of
   ``recognize`` on their decoded arrays, and it must reach
   ``pass_fraction``.
24. jpeg modes: every fixture of ``tests/fixtures/jpeg`` (arithmetic-coded
   sequential and progressive JPEG with ``DAC`` and restarts, the 12
   golden scenes arithmetic-coded from PIL's baseline JPEG of each,
   lossless JPEG of every predictor, sampling factors 3 and 4; written by
   ``scripts/make_jpeg_fixtures.py``) read with ``tools.read`` by path must
   decode to the sha256 of PIL's decode; host decode ms and MB/s of RGB
   out (median of 3) of the 12 golden scenes as SOF9, of scene 3 as
   SOF10, of a 640x480 lossless JPEG (predictor 4, the golden scenes
   tiled) and of scene 3 as run-length TGA and PCX (the lossless file,
   the TGA and the PCX written here by the fixture scripts' numpy
   writers, each decode held to its source pixels); the golden folded
   pipeline reads the 12 SOF9 scenes by path: its words and boxes must
   equal those of ``recognize`` on their decoded arrays, and it must
   reach ``pass_fraction``.

25. jpeg2000: every fixture of ``tests/fixtures/jp2`` (JP2 files and raw
   codestreams: 5/3 and 9/7, every progression order and POC, tiles,
   precincts, layers, the six code-block styles, SOP / EPH, PPM / PPT, ROI,
   subsampled, 12-bit and signed samples, palettes, sYCC and CMYK; written
   by ``scripts/make_jp2_fixtures.py``) read with ``tools.read`` by path
   must decode to the sha256 of PIL's decode; host decode ms and MB/s of
   RGB out (median of 3) of scene 3 as lossy 9/7 and as lossless 5/3 JP2,
   and of the 12 lossy golden scenes decoded once each; the golden folded
   pipeline reads the 12 lossy JP2 scenes by path: its words and boxes
   must equal those of ``recognize`` on their decoded arrays, and it must
   reach ``pass_fraction``; a 640x480 photo as lossy 9/7 JP2 (a fixture,
   checked against PIL when the script wrote it) decoded, then read by the
   full-width folded pipeline by path and as its decoded array in turns
   (median of 3 each, words and boxes equal), the difference being the
   decode's share of the ``recognize`` by path;
26. rasters: every committed fixture of ``tests/fixtures/rasters`` (PSD in
   every colour mode PIL reads, raw and PackBits; QOI; SGI verbatim and
   RLE at 8 and 16 bits; Sun rasters of each depth and type; DIB; DCX;
   ICNS run-length, PNG and JPEG 2000 entries; IM; MSP; XBM; XPM; written
   by ``scripts/make_raster_fixtures.py``) read with ``tools.read`` by path
   must decode to the sha256 of PIL's decode; the script's numpy writers
   write the large files here from the port's reads of their sources (the
   12 golden scenes as PackBits RGB PSD and as QOI, scene 3 as raw PSD and
   RLE SGI, the 640x480 photo as PackBits PSD), each file's sha256 and its
   decode's held to ``hashes.json``; host decode ms and MB/s of RGB out
   (median of 3) of scene 3 in its four forms and of the photo; the golden
   folded pipeline reads the 12 PSD and the 12 QOI scenes by path: words
   and boxes equal to those of their decoded arrays, ``pass_fraction``
   reached; the photo's PSD read by the full-width folded pipeline by path
   and as its decoded array in turns (median of 3 each, words and boxes
   equal).
27. avif: every lossless fixture of ``tests/fixtures/avif`` (lossless AV1 from
   PIL's writer at every subsampling, range, aom speed and container kind
   the script writes, the 12 golden scenes at 4:2:0 in 2x2 tiles, scene 3
   at 4:4:4) read with ``tools.read`` by path must decode to the sha256 of
   PIL's decode, and the files the port refuses must raise
   ``NotImplementedError`` naming the kind; host decode ms and MB/s of RGB
   out (median of 3) of scene 3 at 4:2:0 and 4:4:4; the golden folded
   pipeline reads the 12 AVIF scenes by path: words and boxes equal to
   those of their decoded arrays, ``pass_fraction`` reached; scene 3's
   AVIF read by the full-width folded pipeline by path and as its decoded
   array in turns (median of 3 each, words and boxes equal).
28. lossy avif: every lossy fixture of ``tests/fixtures/avif`` (PIL's
   writer below ``quality=100``: qualities 97 to 5, every subsampling, aom
   speeds 2-10, every intra transform size, deblocking, CDEF, palette,
   tiles, 128x128 superblocks, alpha) read with ``tools.read`` by path
   must decode to the sha256 of PIL's decode, and the lossy files the port
   refuses (loop restoration in use, quantiser matrices) must raise
   ``NotImplementedError`` naming the kind; host decode ms and MB/s of RGB
   out (median of 3) of scene 3 at PIL's default quality at 4:2:0 and
   4:4:4; the golden folded pipeline reads the 12 golden scenes as AVIF at
   PIL's default quality by path: words and boxes equal to those of their
   decoded arrays, ``pass_fraction`` reached; ``tests/fixtures/test_image.jpg``
   as a 640x480 AVIF at PIL's default quality read by the full-width
   folded pipeline by path and as its decoded array in turns (median of 3
   each, words and boxes equal), and the share of the call by path that
   reading takes.

Phases 4-5 (the default path), 6-7 (the folded path), 8 (the refine
path), each run of 9, each golden artifact's run in 10, each
``.pth``-loaded detector's run in 12, the EfficientNet pipeline of 13,
the ``detect`` of 14, the bfloat16 full-width pipelines of 15, each mesh
pipeline of 16, the trained folded bf16 path of 17, each strip
pipeline of 18, the synthetic-trained folded pipeline of 19, the
distributed checkpoint's pipeline of 21, the folded pipelines of 22 and
the golden folded pipeline's reads of the WebP scenes by path in 23,
of the arithmetic-coded JPEG scenes by path in 24, of the JP2 scenes
and photo by path in 25, of the PSD and QOI scenes and the PSD photo
by path in 26, of the AVIF scenes by path in 27 and of the lossy AVIF
scenes and photo by path in 28 count their kernel launches from zero; the
kernel line's launches are those of phases 5-7, 13, 14, 16, 17, 18, 19,
21, 22, 23, 24, 25, 26, 27 and 28 (their sweep calls), and for the bf16
mode's two entries those of 15, 17 and 18;
the kernel ops are
``torch.ops.keras_ocr_tpu_torch.{cc_sweeps, cc_keyed_rows_cols, conv_layer}``,
whose CUDA kernels count. The second-to-last line is the kernel table as
JSON; the last line is ``{"ok": true, "device": {...}}``. There is no CPU
path.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import gc
import math
import os
import platform
import random
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
SHAPES = ((4, 256, 320), (8, 480, 640))
# The 12 conv chains of a full-width CRAFT forward of one 960x1280 input
# (640x480 at scale 2): (name, H, W, Cin, ((k, Cout, relu), ...), pool, tap).
CRAFT_CHAINS = (
    ("C1 slice1_0,3", 960, 1280, 3, ((3, 64, True), (3, 64, True)), True, False),
    ("C2 slice1_7,10", 480, 640, 64, ((3, 128, True), (3, 128, True)), True, True),
    ("C3 slice2_14,17", 240, 320, 128, ((3, 256, True), (3, 256, True)), False, False),
    ("C4 slice3_20", 240, 320, 256, ((3, 256, True),), True, False),
    ("C5 slice3_24,27", 120, 160, 256, ((3, 512, True), (3, 512, True)), False, False),
    ("C6 slice4_30", 120, 160, 512, ((3, 512, True),), True, False),
    ("C7 slice4_34,37", 60, 80, 512, ((3, 512, True), (3, 512, False)), False, False),
    ("upconv1", 60, 80, 1536, ((1, 512, True), (3, 256, True)), False, False),
    ("upconv2", 120, 160, 768, ((1, 256, True), (3, 128, True)), False, False),
    ("upconv3", 240, 320, 384, ((1, 128, True), (3, 64, True)), False, False),
    ("upconv4", 480, 640, 192, ((1, 64, True), (3, 32, True)), False, False),
    ("cls", 480, 640, 32, ((3, 32, True), (3, 32, True), (3, 16, True), (1, 16, True),
                           (1, 2, False)), False, False),
)
# conv3x3_bias_act alone: C3's first layer and an odd size with Cin 3.
CONV3X3_SHAPES = ((1, 240, 320, 128, 256), (2, 13, 37, 3, 16))
CONV_BAR = 1e-4
# The conv kernel takes three TF32 tensor-core products per multiply-add:
# its ceiling is a third of the H100's 495 TFLOP/s dense TF32.
CEILING_TFLOPS = 495 / 3
HEATMAP_BAR = 1e-3
# The H100 SXM's published HBM rate, TB/s: the sweep kernel's bound.
HBM_TBS = 3.35
# The refine phase's heatmaps; its box bars: the CPU run, and the host
# oracle (tests/test_refine.py's 3 px).
REFINE_SHAPE = (8, 480, 640)
REFINE_BAR = 1e-3
ORACLE_BAR = 3.0
# The serving phase's JPEG and the sha256 of PIL's RGB decode of it.
SERVING_JPEG = os.path.join(ROOT, "tests", "fixtures", "test_image.jpg")
SERVING_JPEG_SHA256 = "f5cb48dc1b0a224b4e16c418b92a2e0b851364882e21645efdd244d0fc3207c4"
SERVING_DIR = os.path.join(ROOT, "build", "serving")
# Each kernel's op in torch.ops.keras_ocr_tpu_torch.
OPS = {"cc_sweeps": "cc_sweeps", "cc_keyed_rows_cols": "cc_keyed_rows_cols",
       "conv_chain": "conv_layer", "conv3x3_bias_act": "conv_layer",
       "conv_chain_bf16": "conv_layer", "conv3x3_bias_act_bf16": "conv_layer"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def serpentine(height, width):
    """A snake with a bend every two rows: far more than 8 sweeps."""
    fg = np.zeros((height, width), bool)
    for i, row in enumerate(range(1, height - 1, 2)):
        fg[row, 2 : width - 2] = True
        if row + 2 < height - 1:
            fg[row + 1, width - 3 if i % 2 == 0 else 2] = True
    return fg


def cuda_median_ms(fn, runs=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def sweep_inputs(batch, height, width):
    """Seeded masks of density 0.3-0.8, the last one a serpentine, as
    label-propagation inputs."""
    rng = np.random.RandomState(batch)
    fg = np.stack([rng.rand(height, width) < d for d in np.linspace(0.3, 0.8, batch)])
    fg[-1] = serpentine(height, width)
    sentinel = height * width
    idx = np.arange(sentinel, dtype=np.int32).reshape(height, width)
    values = torch.from_numpy(np.where(fg, idx, sentinel).astype(np.int32)).cuda()
    return fg, values, sentinel


def keyed_inputs(batch, height, width):
    """Seeded dilated-blob covers with blocky component keys."""
    fg, values, sentinel = sweep_inputs(batch, height, width)
    yy, xx = np.mgrid[0:height, 0:width]
    key = np.broadcast_to((yy // 24 * 7 + xx // 40) % 5, fg.shape).astype(np.int32)
    key = np.where(fg, key, -1)
    return values, torch.from_numpy(key).cuda(), torch.from_numpy(fg).cuda(), sentinel


def one_pass(plain, values, planes, rows):
    """One row (or column) pass of the plain sweep ``plain(values, *planes)``
    over (B, H, W) maps: one sweep of each line as a map of one row, whose
    column pass changes nothing."""
    if not rows:
        values, planes = values.transpose(1, 2), [p.transpose(1, 2) for p in planes]
    shape = values.shape

    def lines(t):
        return t.reshape(-1, 1, shape[-1])

    out = plain(lines(values), *map(lines, planes)).reshape(shape)
    return out if rows else out.transpose(1, 2)


def changed_sectors(before, after):
    """The 32 B sectors of int32 maps, laid out as in memory, in which
    ``after`` differs from ``before``."""
    diff = (before != after).flatten().to(torch.int8)
    diff = torch.cat([diff, diff.new_zeros(-diff.numel() % 8)])
    return int(diff.view(-1, 8).any(1).sum())


def sweep_bytes(cc_cuda, values, barrier, sentinel, total):
    """The bytes the passes of one ``cc_sweeps`` call of ``total`` sweeps
    must move, and per image the sweeps it runs: all up to and including
    the first that changes nothing. Each pass that runs reads the labels
    (4 B/px) and the byte barrier (1 B/px); the first pass writes the whole
    output (4 B/px), a later one only the 32 B sectors it changes (the plain
    version, stepped one pass at a time, finds them)."""
    values = values.reshape((-1,) + values.shape[-2:])
    barrier = barrier.reshape(values.shape)
    batch, cells = values.shape[0], values[0].numel()

    def plain(v, b):
        return cc_cuda.segmented_min_sweeps_plain(v, b, sentinel, 1)

    ran = torch.zeros(batch, dtype=torch.int64, device=values.device)
    running = torch.ones_like(ran, dtype=torch.bool)
    nbytes, first = 0, True
    for _ in range(total):
        ran += running
        start = values
        for rows in (True, False):
            swept = one_pass(plain, values, [barrier], rows)
            written = 4 * batch * cells if first else 32 * changed_sectors(values, swept)
            nbytes += 5 * cells * int(running.sum()) + written
            values, first = swept, False
        running &= (values != start).flatten(1).any(1)
    return nbytes, ran.tolist()


def keyed_bytes(cc_cuda, values, key, fg, sentinel):
    """The bytes one ``cc_keyed_rows_cols`` call must move: the row pass
    reads the labels and the key (4 B/px each) and the byte mask (1 B/px)
    and writes the whole output (4 B/px); the column pass reads 9 B/px and
    writes only the 32 B sectors it changes."""

    def plain(v, k, f):
        return cc_cuda.keyed_rows_cols_plain(v, k, f, sentinel)

    rows = one_pass(plain, values, [key, fg], True)
    both = cc_cuda.keyed_rows_cols_plain(values, key, fg, sentinel)
    return 22 * values.numel() + 32 * changed_sectors(rows, both)


def bytes_ms(nbytes):
    """Least time to move ``nbytes`` at HBM_TBS."""
    return nbytes / (HBM_TBS * 1e9)


def exact(what, out, ref, conv=None, ref_conv=None):
    """The largest |out - ref|, which must be 0, flags equal."""
    diff = int((out.to(torch.int64) - ref).abs().max()) if out.numel() else 0
    if diff or (conv is not None and not torch.equal(conv, ref_conv)):
        raise AssertionError(f"{what} disagrees with its plain version: max diff "
                             f"{diff}, converged {conv} vs {ref_conv}")
    return diff


def kernel_phase(cc_cuda):
    """Exact comparison and timing of the two launch entries of the sweep
    kernel against their plain versions; returns, per kernel, its JSON
    entry at (8, 480, 640)."""
    report = {name: {"max_abs_err": 0, "library_ms": None, "bound_by": "bytes"}
              for name in ("cc_sweeps", "cc_keyed_rows_cols")}
    for batch, height, width in SHAPES:
        fg, values, sentinel = sweep_inputs(batch, height, width)
        barrier = torch.from_numpy(~fg).cuda()  # bool, as the main path passes it
        for sweeps in (1, 8):
            out, conv = cc_cuda.segmented_min_sweeps(values, barrier, sentinel, sweeps, True)
            ref, ref_conv = cc_cuda.segmented_min_sweeps_plain(
                values, barrier, sentinel, sweeps, True
            )
            torch.cuda.synchronize()
            diff = exact(f"cc_sweeps {(batch, height, width)}, {sweeps} sweeps",
                         out, ref, conv, ref_conv)
            report["cc_sweeps"]["max_abs_err"] = max(report["cc_sweeps"]["max_abs_err"], diff)
        if bool(ref_conv[-1]):
            raise AssertionError("the serpentine mask converged at 8 sweeps")
        ms = cuda_median_ms(
            lambda: cc_cuda.segmented_min_sweeps(values, barrier, sentinel, 8, True)
        )
        plain_ms = cuda_median_ms(
            lambda: cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, 8, True)
        )
        nbytes, ran = sweep_bytes(cc_cuda, values, barrier, sentinel, 9)
        cells = height * width
        full_ms = bytes_ms(18 * 9 * batch * cells)
        bound_ms = bytes_ms(nbytes)
        report["cc_sweeps"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(
            f"kernel vs plain: cc_sweeps {(batch, height, width)} exact, converged "
            f"{conv.tolist()}, 8 sweeps + check: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (median of 20); a full pass moves {batch * cells * 9 / 1e6:.2f} "
            f"MB (9 B/px), 18 of them {full_ms:.4f} ms ({100 * full_ms / ms:.1f}% of the "
            f"kernel's time); sweeps run per image {ran}; the passes run must move "
            f"{nbytes / 1e6:.2f} MB (5 B/px read, the changed sectors written): bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%)"
        )
        keyed = keyed_inputs(batch, height, width)
        out = cc_cuda.keyed_rows_cols(*keyed)
        ref = cc_cuda.keyed_rows_cols_plain(*keyed)
        torch.cuda.synchronize()
        diff = exact(f"cc_keyed_rows_cols {(batch, height, width)}", out, ref)
        report["cc_keyed_rows_cols"]["max_abs_err"] = max(
            report["cc_keyed_rows_cols"]["max_abs_err"], diff)
        ms = cuda_median_ms(lambda: cc_cuda.keyed_rows_cols(*keyed))
        plain_ms = cuda_median_ms(lambda: cc_cuda.keyed_rows_cols_plain(*keyed))
        full_ms = bytes_ms(2 * 13 * batch * cells)
        nbytes = keyed_bytes(cc_cuda, *keyed)
        bound_ms = bytes_ms(nbytes)
        report["cc_keyed_rows_cols"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(
            f"kernel vs plain: cc_keyed_rows_cols {(batch, height, width)} exact, "
            f"one row + column pass: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(median of 20); a full pass moves {batch * cells * 13 / 1e6:.2f} MB (13 B/px), "
            f"two of them {full_ms:.4f} ms ({100 * full_ms / ms:.1f}%); the call must move "
            f"{nbytes / 1e6:.2f} MB (the column pass writes its changed sectors): bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%)"
        )
    return report


def golden_traffic(cc_cuda, pipeline, scenes):
    """The sweep-kernel calls of one ``get_boxes`` on the golden artifact's
    own heatmaps (its first 8 scenes as one batch): each recorded as the
    main path makes it, then held exact against its plain version and
    timed."""
    from keras_ocr_tpu_torch.ops import cc, postprocess

    calls = {"cc_sweeps": [], "cc_keyed_rows_cols": []}

    def record_sweeps(values, barrier, sentinel, num_sweeps, check_convergence=False):
        calls["cc_sweeps"].append((values.clone(), barrier.clone(), sentinel, num_sweeps))
        return cc_cuda.segmented_min_sweeps(
            values, barrier, sentinel, num_sweeps, check_convergence)

    def record_keyed(values, key, fg, sentinel):
        calls["cc_keyed_rows_cols"].append((values.clone(), key.clone(), fg.clone(), sentinel))
        return cc_cuda.keyed_rows_cols(values, key, fg, sentinel)

    saved = cc.segmented_min_sweeps, cc.keyed_rows_cols
    cc.segmented_min_sweeps, cc.keyed_rows_cols = record_sweeps, record_keyed
    try:
        with torch.inference_mode():
            heatmaps = pipeline.detector.model(craft_input(pipeline, scenes))
            postprocess.get_boxes(heatmaps, max_components=pipeline.detector.max_components)
            torch.cuda.synchronize()
    finally:
        cc.segmented_min_sweeps, cc.keyed_rows_cols = saved
    with torch.inference_mode():
        totals = {"cc_sweeps": [0.0, 0.0, 0.0], "cc_keyed_rows_cols": [0.0, 0.0, 0.0]}
        ran_all = []
        for values, barrier, sentinel, sweeps in calls["cc_sweeps"]:
            out, conv = cc_cuda.segmented_min_sweeps(values, barrier, sentinel, sweeps, True)
            ref, ref_conv = cc_cuda.segmented_min_sweeps_plain(
                values, barrier, sentinel, sweeps, True)
            torch.cuda.synchronize()
            exact("cc_sweeps on the golden masks", out, ref, conv, ref_conv)
            nbytes, ran = sweep_bytes(cc_cuda, values, barrier, sentinel, sweeps + 1)
            ran_all.append(ran)
            times = totals["cc_sweeps"]
            times[0] += cuda_median_ms(
                lambda: cc_cuda.segmented_min_sweeps(values, barrier, sentinel, sweeps, True))
            times[1] += cuda_median_ms(
                lambda: cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, sweeps, True))
            times[2] += bytes_ms(nbytes)
        for args in calls["cc_keyed_rows_cols"]:
            out = cc_cuda.keyed_rows_cols(*args)
            ref = cc_cuda.keyed_rows_cols_plain(*args)
            torch.cuda.synchronize()
            exact("cc_keyed_rows_cols on the golden masks", out, ref)
            times = totals["cc_keyed_rows_cols"]
            times[0] += cuda_median_ms(lambda: cc_cuda.keyed_rows_cols(*args))
            times[1] += cuda_median_ms(lambda: cc_cuda.keyed_rows_cols_plain(*args))
            times[2] += bytes_ms(keyed_bytes(cc_cuda, *args))
    shape = tuple(calls["cc_sweeps"][0][0].shape)
    (ms, plain_ms, bound_ms), (kms, kplain_ms, kbound_ms) = totals.values()
    print(f"kernel vs plain on the golden masks (one get_boxes of {shape}, exact): "
          f"cc_sweeps {len(calls['cc_sweeps'])} calls, sweeps run per image {ran_all}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({100 * bound_ms / ms:.1f}%); cc_keyed_rows_cols {len(calls['cc_keyed_rows_cols'])} "
          f"calls: kernel {kms:.4f} ms, plain {kplain_ms:.4f} ms, bound {kbound_ms:.4f} ms "
          f"({100 * kbound_ms / kms:.1f}%) (sums of medians of 20)")


def check_results(results, count):
    if len(results) != count:
        raise AssertionError(f"{len(results)} results for {count} images")
    for words in results:
        for word, box in words:
            if not isinstance(word, str) or box.shape != (4, 2) or not np.isfinite(box).all():
                raise AssertionError(f"malformed result ({word!r}, {box})")


def seeded_chain(gen, batch, height, width, cin, plan):
    """A seeded NHWC input and HWIO convs scaled by 1/sqrt(K), so the
    activations stay O(1) through the chain."""
    x = torch.randn((batch, height, width, cin), generator=gen, device="cuda")
    convs = []
    for k, cout, relu in plan:
        w = torch.randn((k, k, cin, cout), generator=gen, device="cuda") / math.sqrt(k * k * cin)
        b = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
        convs.append((w, b, relu))
        cin = cout
    return x, convs


def conv_flop(batch, height, width, cin, plan):
    total = 0
    for k, cout, _ in plan:
        total += 2 * batch * height * width * k * k * cin * cout
        cin = cout
    return total


def conv_bytes(batch, height, width, cin, plan, pool=False, tap=False):
    """fp32 bytes a chain must move: each layer reads its input and
    weights and writes its output (pooled a quarter, and the tap as well)."""
    total = 0
    for i, (k, cout, _) in enumerate(plan):
        out = batch * height * width * cout
        if pool and i == len(plan) - 1:
            out = out // 4 + (out if tap else 0)
        total += 4 * (batch * height * width * cin + k * k * cin * cout + cout + out)
        cin = cout
    return total


def conv_bound_ms(flop, nbytes):
    """The larger of the operations at the 3xTF32 ceiling and the bytes at
    the HBM rate."""
    return max(flop / (CEILING_TFLOPS * 1e9), nbytes / (HBM_TBS * 1e9))


def check_close(what, out, ref, bar, relative=False):
    """max|out - ref|, which must be <= bar * max(1, max|ref|); with
    ``relative``, also that difference over max(1, max|ref|)."""
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    if not err <= bar * scale:
        raise AssertionError(f"{what}: max |diff| {err} above {bar} * {scale}")
    return (err, err / scale) if relative else err


def conv_phase(conv_cuda):
    """Both conv wrappers against their plain versions (cuDNN) at the CRAFT
    shapes; returns, per kernel, the largest difference and (kernel ms,
    plain ms): the sum over the 12 chains for ``conv_chain``, C3's first
    layer for ``conv3x3_bias_act``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"conv_chain": {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                             "bound_by": "operations", "library_ms": None},
              "conv3x3_bias_act": {"max_abs_err": 0.0, "bound_by": "operations"}}
    total_flop = total_bytes = 0
    for name, height, width, cin, plan, pool, tap in CRAFT_CHAINS:
        x, convs = seeded_chain(gen, 1, height, width, cin, plan)

        def kernel():
            return conv_cuda.conv_chain(x, convs, pool=pool, tap_prepool=tap)

        def plain():
            return conv_cuda.conv_chain_plain(x, convs, pool=pool, tap_prepool=tap)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(out, ref, ("output", "tap"))) if tap else [(out, ref, "output")]
        errs = [check_close(f"conv_chain {name} {what}", o, r, CONV_BAR, relative=True)
                for o, r, what in pairs]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        chain = report["conv_chain"]
        chain["max_abs_err"] = max(chain["max_abs_err"], err)
        ms, plain_ms = cuda_median_ms(kernel), cuda_median_ms(plain)
        chain["ms"] += ms
        chain["plain_ms"] += plain_ms
        chain.setdefault("per_chain", {})[name] = ms
        flop = conv_flop(1, height, width, cin, plan)
        total_flop += flop
        total_bytes += conv_bytes(1, height, width, cin, plan, pool, tap)
        tflops = flop / ms / 1e9
        print(f"kernel vs plain: conv_chain {name} (1, {height}, {width}, {cin}) "
              f"{[p[:2] for p in plan]}{' pool' if pool else ''}{' tap' if tap else ''}: "
              f"max |diff| {err:.3e} ({rel:.2e} of max(1, max|plain|)); {flop / 1e9:.2f} "
              f"GFLOP, kernel {ms:.4f} ms ({tflops:.2f} TFLOP/s, "
              f"{100 * tflops / CEILING_TFLOPS:.1f}% of the 3xTF32 ceiling; Cout tiles "
              f"{[conv_cuda.tile_n(p[1]) for p in plan]}), plain {plain_ms:.4f} ms "
              f"({flop / plain_ms / 1e9:.2f} TFLOP/s) (median of 20)")
    ms, plain_ms = report["conv_chain"]["ms"], report["conv_chain"]["plain_ms"]
    report["conv_chain"]["bound_ms"] = conv_bound_ms(total_flop, total_bytes)
    print(f"kernel vs plain: conv_chain, the 12 chains of one 960x1280 CRAFT forward: "
          f"{total_flop / 1e9:.2f} GFLOP, {total_bytes / 1e9:.2f} GB, kernel {ms:.4f} ms "
          f"({total_flop / ms / 1e9:.2f} TFLOP/s, {100 * total_flop / ms / 1e9 / CEILING_TFLOPS:.1f}% "
          f"of the {CEILING_TFLOPS:.0f} TFLOP/s 3xTF32 ceiling), plain {plain_ms:.4f} ms "
          f"({total_flop / plain_ms / 1e9:.2f} TFLOP/s)")
    for batch, height, width, cin, cout in CONV3X3_SHAPES:
        x, ((w, b, _),) = seeded_chain(gen, batch, height, width, cin, ((3, cout, True),))
        for relu in (True, False):
            out = conv_cuda.conv3x3_bias_act(x, w, b, relu=relu)
            ref = conv_cuda.conv3x3_bias_act_plain(x, w, b, relu=relu)
            torch.cuda.synchronize()
            err = check_close(f"conv3x3_bias_act {(batch, height, width, cin, cout)}",
                              out, ref, CONV_BAR)
            single = report["conv3x3_bias_act"]
            single["max_abs_err"] = max(single["max_abs_err"], err)
        ms = cuda_median_ms(lambda: conv_cuda.conv3x3_bias_act(x, w, b))
        plain_ms = cuda_median_ms(lambda: conv_cuda.conv3x3_bias_act_plain(x, w, b))
        # The library call: one cuDNN convolution with its bias, NCHW, the
        # layout change and the ReLU left out.
        x_nchw, w_oihw = x.permute(0, 3, 1, 2).contiguous(), w.permute(3, 2, 0, 1).contiguous()
        library_ms = cuda_median_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, b, padding=1))
        flop = conv_flop(batch, height, width, cin, ((3, cout, True),))
        bound_ms = conv_bound_ms(flop, conv_bytes(batch, height, width, cin, ((3, cout, True),)))
        if "ms" not in report["conv3x3_bias_act"]:
            report["conv3x3_bias_act"].update(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms)
        print(f"kernel vs plain: conv3x3_bias_act {(batch, height, width, cin)} -> {cout}: "
              f"max |diff| {err:.3e}; {flop / 1e9:.3f} GFLOP, kernel {ms:.4f} ms "
              f"({flop / ms / 1e9:.2f} TFLOP/s; bound {bound_ms:.4f} ms, "
              f"{100 * bound_ms / ms:.1f}% of it), plain {plain_ms:.4f} ms "
              f"({flop / plain_ms / 1e9:.2f} TFLOP/s), F.conv2d with bias {library_ms:.4f} ms "
              "(median of 20)")
    return report


def enqueue_without_sync(pipeline, scenes, refine_level=0):
    """Enqueue the device program of a batch under sync debug mode
    "error": any host synchronisation raises."""
    device_batch, _, _, resize_to = pipeline._prepare(scenes)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the debug mode's "prototype" notice
        torch.cuda.set_sync_debug_mode("error")
        try:
            pipeline._launch(
                device_batch, {}, pipeline.word_buckets[0], resize_to,
                pipeline._component_cap, pipeline._num_sweeps, refine_level,
            )
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def time_pipeline(pipeline, scenes, repeats=10):
    """(recognize p50 ms over ``repeats`` images, recognize_many images/s
    on 32 images at batch 8), checking every result."""
    latencies = []
    for image in scenes[:repeats]:
        start = time.perf_counter()
        results = pipeline.recognize([image])
        latencies.append((time.perf_counter() - start) * 1e3)
        check_results(results, 1)
    many = (scenes * 3)[:32]
    check_results(pipeline.recognize_many(many, batch_size=8), len(many))
    start = time.perf_counter()
    results = pipeline.recognize_many(many, batch_size=8)
    images_per_s = len(many) / (time.perf_counter() - start)
    check_results(results, len(many))
    return statistics.median(latencies), images_per_s


def seed_batch_norm(model, seed):
    """Non-trivial BatchNorm statistics (scale 0.5-1.5, shift and mean
    +-0.1, variance 0.5-2), so that a fold has something to fold."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                n = module.num_features

                def uniform(low, high):
                    return low + (high - low) * torch.rand(n, generator=gen)

                module.weight.copy_(uniform(0.5, 1.5))
                module.bias.copy_(uniform(-0.1, 0.1))
                module.running_mean.copy_(uniform(-0.1, 0.1))
                module.running_var.copy_(uniform(0.5, 2.0))


def craft_input(pipeline, scenes):
    """The normalised CRAFT input the pipeline makes of ``scenes``."""
    from keras_ocr_tpu_torch.ops.image import compute_input, resize_bilinear

    (device_batch,), _, _, resize_to = pipeline._prepare(scenes)
    return compute_input(resize_bilinear(device_batch.to(torch.float32), *resize_to))


def split_word(text, link, y, x, left, gap, right, height=8):
    """Two text islands joined by a bridge where text and link both pass
    their thresholds: overlap removal cuts the bridge, and the gap is wider
    than the dilation closes, so the word's dilated segmap is two blobs."""
    text[y : y + height, x : x + left] = 0.95
    text[y : y + height, x + left + gap : x + left + gap + right] = 0.9
    mid = y + height // 2 - 1
    text[mid : mid + 2, x + left : x + left + gap] = 0.45
    link[mid : mid + 2, x + left - 1 : x + left + gap + 1] = 0.5


def refine_heatmaps(seed=0):
    """(8, 480, 640, 2) float32 heatmaps: five seeded split words an image,
    one row band each; image 0 also holds a blob nested in a ring's hole
    (bridged to a far island), and image 1's middle word is 540 columns
    wide, past level 1's 512-column window."""
    batch, height, width = REFINE_SHAPE
    rng = np.random.RandomState(seed)
    maps = np.zeros((batch, height, width, 2), np.float32)
    for b in range(batch):
        text, link = maps[b, ..., 0], maps[b, ..., 1]
        for k in range(5):
            y = 30 + 90 * k
            if b == 1 and k == 2:
                split_word(text, link, y, 40, 250, 40, 250)
                continue
            split_word(text, link, y, rng.randint(10, width - 100), rng.randint(8, 21),
                       rng.randint(14, 31), rng.randint(8, 21))
    text, link = maps[0, 440:, 300:, 0], maps[0, 440:, 300:, 1]
    text[10:30, 10:30] = 0.95
    text[16:24, 16:24] = 0.45
    link[15:25, 15:25] = 0.5
    text[18:22, 18:22] = 0.95
    link[17:23, 17:23] = 0.3
    link[18:22, 18:22] = 0.35
    text[19:21, 30:50] = 0.45
    link[19:21, 29:51] = 0.5
    text[12:28, 50:58] = 0.9
    return maps


class FixedCraft(torch.nn.Module):
    """A CRAFT stand-in returning fixed heatmaps for a batch of the size
    they were made for (inputs twice their height and width)."""

    def __init__(self, heatmaps):
        super().__init__()
        self.heatmaps = heatmaps

    def forward(self, x):
        if x.shape[0] != self.heatmaps.shape[0] or x.shape[1] != 2 * self.heatmaps.shape[1]:
            raise AssertionError(f"stand-in CRAFT got {tuple(x.shape)}")
        return self.heatmaps


def canonical(boxes):
    """Boxes in a fixed order, for comparing two unordered lists."""
    return np.array(sorted(boxes.tolist(), key=lambda b: (np.sum(b), b[0][0])))


def checked_sweeps(cc, cc_cuda, record):
    """Swap the sweep kernel's two entries in ``cc`` for versions that also
    run the plain version on the same tensors and require equal maps and
    flags; ``record`` collects (entry, shape) per call. Returns an undo."""
    saved = cc.segmented_min_sweeps, cc.keyed_rows_cols

    def sweeps(values, barrier, sentinel, num_sweeps, check_convergence=False):
        out = cc_cuda.segmented_min_sweeps(values, barrier, sentinel, num_sweeps,
                                           check_convergence)
        ref = cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, num_sweeps,
                                                 check_convergence)
        if check_convergence:
            exact("cc_sweeps on the refine path", out[0], ref[0], out[1], ref[1])
        else:
            exact("cc_sweeps on the refine path", out, ref)
        record.append(("cc_sweeps", tuple(values.shape)))
        return out

    def keyed(values, key, fg, sentinel):
        out = cc_cuda.keyed_rows_cols(values, key, fg, sentinel)
        exact("cc_keyed_rows_cols on the refine path", out,
              cc_cuda.keyed_rows_cols_plain(values, key, fg, sentinel))
        record.append(("cc_keyed_rows_cols", tuple(values.shape)))
        return out

    cc.segmented_min_sweeps, cc.keyed_rows_cols = sweeps, keyed

    def undo():
        cc.segmented_min_sweeps, cc.keyed_rows_cols = saved

    return undo


def device_busy(fn):
    """(device busy ms, of it the sweep kernel's passes, device operations)
    of one call of ``fn``, from ``torch.profiler``: a call that enqueues
    more launches than the device's queue holds makes the host wait, so its
    event time is not its device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sweep = 0.0
    count = 0
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = event.self_device_time_total / 1e3
        busy += ms
        count += event.count
        if "sweep_pass" in event.key:
            sweep += ms
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return busy, sweep, count


def refine_levels(cc, cc_cuda, postprocess, refine, heatmaps):
    """``get_boxes`` + ``refine_boxes`` at each LADDER level on the card,
    every sweep-kernel call checked; level 1 against the CPU run, levels 2
    and 3 against level 1 where both prove an image. Returns per level
    (enqueue ms, device ms, sweep launches, maps in the window batch)."""
    cpu = heatmaps.cpu()
    analysis = postprocess.component_analysis(heatmaps, 0.7, 0.4, 0.4, 10, 256,
                                              per_component_census=True)
    boxes, _, _ = postprocess.get_boxes(heatmaps, analysis=analysis)
    timings, first = [], None
    for level, (wh, ww, md, it, rc) in enumerate(refine.LADDER, 1):
        settings = dict(refine_cap=rc, window_h=wh, window_w=ww, max_dilate=md, num_iters=it)

        def call():
            return refine.refine_boxes(heatmaps, boxes, analysis=analysis, **settings)

        record = []
        undo = checked_sweeps(cc, cc_cuda, record)
        try:
            out, ok, flagged = (t.cpu() for t in call())
        finally:
            undo()
        if level == 1:
            ref_analysis = postprocess.component_analysis(cpu, 0.7, 0.4, 0.4, 10, 256,
                                                          per_component_census=True)
            ref_boxes, _, _ = postprocess.get_boxes(cpu, analysis=ref_analysis)
            ref = refine.refine_boxes(cpu, ref_boxes, analysis=ref_analysis, **settings)
            if not (torch.equal(ok, ref[1]) and torch.equal(flagged, ref[2])):
                raise AssertionError(f"refine level 1: ok {ok} / {ref[1]}, flagged "
                                     f"{flagged} / {ref[2]} on the card / CPU")
            err = float((out - ref[0]).abs().max())
            if not err <= REFINE_BAR:
                raise AssertionError(f"refine level 1 boxes {err} px from the CPU run")
            if ok.tolist() != [True, False] + [True] * 6:
                raise AssertionError(f"refine level 1 proofs {ok.tolist()}")
            first = out, ok
        else:
            if not bool(ok.all()):
                raise AssertionError(f"refine level {level} proofs {ok.tolist()}")
            both = first[1] & ok
            err = float((out[both] - first[0][both]).abs().max())
            if not err <= REFINE_BAR:
                raise AssertionError(f"refine level {level} boxes {err} px from level 1's")
        if flagged.tolist() != [6] + [5] * 7:
            raise AssertionError(f"refine level {level} flagged {flagged.tolist()}")
        maps = {(math.prod(shape[:-2]),) + shape[-2:] for name, shape in record
                if name == "cc_sweeps"}
        call()
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            launches = cc_cuda.segmented_min_sweeps.launches
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin = time.perf_counter()
            start.record()
            call()
            stop.record()
            enqueue_ms = (time.perf_counter() - begin) * 1e3
            torch.cuda.synchronize()
            runs.append((enqueue_ms, start.elapsed_time(stop),
                         cc_cuda.segmented_min_sweeps.launches - launches))
        enqueue_ms, event_ms, launches = (statistics.median(r[i] for r in runs) for i in range(3))
        busy_ms, sweep_ms, ops = device_busy(call)
        timings.append((enqueue_ms, event_ms, busy_ms, sweep_ms, ops, launches, sorted(maps),
                        len(record)))
    return timings


def refine_phase(card, detector, recognizer, scenes):
    """Phase 8; returns the sweep-kernel launches of the refine path."""
    from keras_ocr_tpu_torch import Detector, Pipeline, detection
    from keras_ocr_tpu_torch.ops import cc, cc_cuda, postprocess, refine

    heatmaps = torch.from_numpy(refine_heatmaps()).cuda()
    with torch.inference_mode():
        timings = refine_levels(cc, cc_cuda, postprocess, refine, heatmaps)

    stand_in = Detector(weights=None, width=0.25, device="cuda")
    stand_in.model = FixedCraft(heatmaps)
    images = [np.zeros((960, 1280, 3), np.uint8)] * REFINE_SHAPE[0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        found = stand_in.detect(images)
        host = detection.getBoxes(heatmaps.cpu().numpy())
        start = time.perf_counter()
        full = detector.detect(scenes[:8])
        detect_ms = (time.perf_counter() - start) * 1e3
    if caught:
        raise AssertionError(f"Detector.detect warned: {[str(w.message) for w in caught]}")
    for image, (got, want) in enumerate(zip(found, host)):
        if len(got) != len(want):
            raise AssertionError(f"detect image {image}: {len(got)} boxes, oracle {len(want)}")
        err = float(np.abs(canonical(got) - canonical(want)).max())
        if not err <= ORACLE_BAR:
            raise AssertionError(f"detect image {image}: {err} px from the oracle")
    check_results([[("", box) for box in boxes] for boxes in full], 8)

    pipeline = Pipeline(detector=stand_in, recognizer=recognizer, scale=2)
    for level in range(len(refine.LADDER) + 1):
        enqueue_without_sync(pipeline, scenes[:8], refine_level=level)
    relaunch_ms = []
    for level in range(len(refine.LADDER) + 1):
        device_batch, _, _, resize_to = pipeline._prepare(scenes[:8])

        def launch():
            return [packed.cpu() for packed in pipeline._launch(
                device_batch, {}, pipeline.word_buckets[0], resize_to, pipeline._component_cap,
                pipeline._num_sweeps, level)]

        launch()
        runs = []
        for _ in range(3):
            start = time.perf_counter()
            launch()
            runs.append((time.perf_counter() - start) * 1e3)
        relaunch_ms.append(statistics.median(runs))
    for wrapper in (cc_cuda.segmented_min_sweeps, cc_cuda.keyed_rows_cols):
        wrapper.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        start = time.perf_counter()
        results = pipeline.recognize(scenes[:8])
        recognize_ms = (time.perf_counter() - start) * 1e3
    launches = {"cc_sweeps": cc_cuda.segmented_min_sweeps.launches,
                "cc_keyed_rows_cols": cc_cuda.keyed_rows_cols.launches}
    check_results(results, 8)
    stats = pipeline.last_run_stats
    if any("contours[0]" in str(w.message) for w in caught) or stats["refine_escalations"] < 1:
        raise AssertionError(f"the refine ladder did not end clear: {stats}, "
                             f"{[str(w.message) for w in caught]}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the refine path was never launched: {launches}")
    levels = "; ".join(
        f"level {i}: sweep-kernel maps {maps}, host enqueue {enq:.2f} ms, event {event:.2f} ms, "
        f"device busy {busy:.2f} ms of which the sweep kernel {sweep:.2f} ms, {ops} device "
        f"operations, {n} cc_sweeps launches ({calls} checked calls exact)"
        for i, (enq, event, busy, sweep, ops, n, maps, calls) in enumerate(timings, 1)
    )
    print(f"refine ({card}), (8, 480, 640) split-word heatmaps: {levels}; level 1 equal to "
          f"the CPU run, levels 2-3 to level 1; Detector.detect on the stand-in: no host "
          f"fallback, {sum(len(b) for b in found)} boxes within {ORACLE_BAR} px of getBoxes; "
          f"full-width Detector.detect of 8 scenes {detect_ms:.1f} ms, "
          f"{sum(len(b) for b in full)} boxes; pipeline launch + fetch at refine levels "
          f"0-3 {[round(t, 2) for t in relaunch_ms]} ms (median of 3), enqueued without a host "
          f"synchronisation at each; recognize of 8 scenes with the refine ladder "
          f"{recognize_ms:.1f} ms, last_run_stats {stats}; launches on the refine path {launches}")
    return launches


def as_annotations(results, names):
    """Pipeline results of one image a scene -> ``evaluation.score``'s
    image id -> [{"text", "vertices"}]."""
    return {name: [{"text": word, "vertices": box} for word, box in words]
            for name, words in zip(names, results)}


def two_stage_golden(label, pipeline, images, expected, fused, wrappers, pass_fraction):
    """The golden scenes through the two-stage path, the launch counts
    from zero; the word fraction and the score against the fused results
    must reach ``pass_fraction``. Returns the launches and a summary."""
    from keras_ocr_tpu_torch import evaluation
    from keras_ocr_tpu_torch.utils import golden

    for wrapper in wrappers.values():
        wrapper.launches = 0
    results = [pipeline.recognize([image], recognition_kwargs={"verbose": 0})[0]
               for image in images]
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    check_results(results, len(images))
    hits = sum(golden._word_match_fraction(words, [w for w, _ in found]) * len(words)
               for words, found in zip(expected, results))
    n_words = sum(len(words) for words in expected)
    fraction = hits / n_words
    names = [f"scene_{i:02d}" for i in range(len(images))]
    _, (precision, recall) = evaluation.score(as_annotations(fused, names),
                                              as_annotations(results, names))
    same = sum(sorted(w for w, _ in a) == sorted(w for w, _ in b)
               for a, b in zip(results, fused))
    if min(fraction, precision, recall) < pass_fraction:
        raise AssertionError(f"two-stage {label}: fraction {fraction}, precision {precision}, "
                             f"recall {recall} (pass >= {pass_fraction})")
    return launches, (f"{label}: fraction {fraction:.4f} over {n_words} words, "
                      f"score against the fused path precision {precision:.4f} recall "
                      f"{recall:.4f}, same word multiset on {same}/{len(images)} scenes, "
                      f"launches {launches}")


def two_stage_phase(card, golden_images, expected, pipelines, wrappers, pass_fraction,
                    full_pipeline, fused_p50):
    """Phase 9: the two-stage ``recognition_kwargs`` path on the golden
    artifact (unfolded and folded), each run's kernel launches counted from
    zero; the full-width CRNN on the card against the CPU on the slim
    detector's crops; the two-stage p50 at full width and its stage
    split."""
    import copy

    from keras_ocr_tpu_torch import recognition, tools

    lines = []
    for label, pipeline in pipelines:
        fused = [pipeline.recognize([image])[0] for image in golden_images]
        launches, line = two_stage_golden(label, pipeline, golden_images, expected, fused,
                                          wrappers, pass_fraction)
        needed = ("cc_sweeps", "cc_keyed_rows_cols") + (
            ("conv_chain", "conv3x3_bias_act") if "folded" in label else ())
        if min(launches[name] for name in needed) <= 0:
            raise AssertionError(f"two-stage {label} skipped a kernel: {launches}")
        lines.append(line)

    # The full-width CRNN on the card and on the CPU, on the crops of the
    # slim detector's boxes in the golden scenes padded to 640x480.
    slim = pipelines[0][1]
    recognizer = full_pipeline.recognizer

    def host_batch(scene):
        """The two-stage path's host resize and pad of one scene."""
        resized, _, extent = full_pipeline._resize_on_host([scene])
        return full_pipeline._pad_batch(resized, *extent)

    scenes = [tools.pad(image, width=640, height=480) for image in golden_images[:10]]
    batches = [host_batch(scene) for scene in scenes]
    boxes = [slim.detector.detect(images=batch)[0] for batch in batches]
    crops = [tools.warpBox(recognition.rgb_to_grayscale_host(batch[0]), box, 31, 200)
             for batch, image_boxes in zip(batches[:2], boxes[:2]) for box in image_boxes]
    x = torch.from_numpy(np.array(crops, dtype=np.float32)[..., None] / 255)
    cpu_model = copy.deepcopy(recognizer.model).cpu()
    with torch.inference_mode():
        card_probs = recognizer.model(x.cuda()).cpu()
        cpu_probs = cpu_model(x)
    err = check_close("full-width CRNN softmax, card vs CPU", card_probs, cpu_probs, 1e-4)

    # Two-stage p50 at full width, then its stages timed one by one (the
    # crops and the CRNN on the slim detector's boxes: the random-weight
    # CRAFT finds no words).
    latencies, found = [], 0
    full_pipeline.recognize([scenes[0]], recognition_kwargs={"verbose": 0})
    for scene in scenes:
        start = time.perf_counter()
        results = full_pipeline.recognize([scene], recognition_kwargs={"verbose": 0})
        latencies.append((time.perf_counter() - start) * 1e3)
        check_results(results, 1)
        found += len(results[0])
    stages = {"host resize": [], "detect": [], "host crops": [], "CRNN + CTC": []}
    for scene, image_boxes in zip(scenes, boxes):
        start = time.perf_counter()
        batch = host_batch(scene)
        mid = time.perf_counter()
        full_pipeline.detector.detect(images=batch)
        detected = time.perf_counter()
        grey = recognition.rgb_to_grayscale_host(batch[0])
        word_crops = np.array([tools.warpBox(grey, box, 31, 200) for box in image_boxes],
                              dtype=np.float32)[..., None] / 255
        cropped = time.perf_counter()
        recognizer._predict_strings(word_crops)
        done = time.perf_counter()
        for name, (a, b) in zip(stages, ((start, mid), (mid, detected), (detected, cropped),
                                         (cropped, done))):
            stages[name].append((b - a) * 1e3)
    split = ", ".join(f"{name} {statistics.median(ms):.2f}" for name, ms in stages.items())
    print(f"two-stage ({card}): " + "; ".join(lines) + f"; full-width CRNN softmax on "
          f"{len(crops)} crops of 2 scenes within {err:.3e} of the CPU run (bar 1e-4); "
          f"full width (640x480, scale 2) recognize p50 with recognition_kwargs "
          f"{statistics.median(latencies):.2f} ms ({found} words found in 10 scenes), fused "
          f"p50 {fused_p50:.2f} ms; stage medians over 10 scenes, "
          f"{statistics.median(len(b) for b in boxes)} words a scene: {split} ms")


def host_cpu() -> str:
    """The host's CPU model: ``/proc/cpuinfo``, else ``lscpu``, else the
    machine type."""
    with open("/proc/cpuinfo", encoding="utf8") as f:
        for line in f:
            if line.lower().startswith("model name"):
                return line.split(":", 1)[1].strip()
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except OSError:
        out = ""
    for line in out.splitlines():
        if line.startswith("Model name:"):
            return line.split(":", 1)[1].strip()
    return f"CPU model not reported ({platform.machine()}, {os.cpu_count()} cores)"


def timed_export(pipeline, path, **kwargs):
    """``pipeline.export(path, **kwargs)``, then ``load_exported``; returns
    the served artifact and (export s, save s, load s), the save timed
    inside the export."""
    from keras_ocr_tpu_torch import load_exported

    save, seconds = torch.export.save, {}

    def timed_save(*args, **save_kwargs):
        start = time.perf_counter()
        save(*args, **save_kwargs)
        seconds["save"] = time.perf_counter() - start

    torch.export.save = timed_save
    try:
        start = time.perf_counter()
        pipeline.export(path, **kwargs)
        total = time.perf_counter() - start
    finally:
        torch.export.save = save
    start = time.perf_counter()
    served = load_exported(path)
    load_s = time.perf_counter() - start
    return served, (total - seconds["save"], seconds["save"], load_s)


def export_summary(served, path, seconds):
    export_s, save_s, load_s = seconds
    return (f"export {export_s:.2f} s, save {save_s:.2f} s, load {load_s:.2f} s, "
            f"{os.path.getsize(path + '.pt2') / 1e6:.2f} MB, "
            f"{len(served._program.graph.nodes)} graph nodes")


def serve_golden(label, pipeline, images, expected, wrappers, pass_fraction):
    """The golden pipeline exported on the card (batch 4), loaded and
    served the scenes, the launch counts from zero over the artifact's
    run; every packed output must equal the live device program's at the
    baked levels and the word fraction reach ``pass_fraction``. Returns the
    launches and a summary."""
    from keras_ocr_tpu_torch.utils import golden

    meta = golden._read_json(ARTIFACT, golden.META_NAME)
    height, width = meta["pad_to"]
    path = os.path.join(SERVING_DIR, label.replace(", ", "_"))
    served, seconds = timed_export(pipeline, path, height=height, width=width, batch_size=4)
    program, runs = served._program, []

    def recorded(batch):
        runs.append((batch, program(batch)))
        return runs[-1][1]

    served._program = recorded
    for wrapper in wrappers.values():
        wrapper.launches = 0
    try:
        results = [words for i in range(0, len(images), 4)
                   for words in served.recognize(images[i : i + 4])]
    finally:
        served._program = program
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    check_results(results, len(images))
    baked = served.meta
    for batch, packed in runs:
        live = pipeline._device_pipeline(
            batch, 0.7, 0.4, 0.4, 10.0, pipeline.detector.max_components, baked["max_words"],
            resize_to=(height * baked["scale"], width * baked["scale"]),
            refine_level=baked["refine_level"], warp_level=baked["warp_level"],
        )
        if not torch.equal(live, packed):
            raise AssertionError(f"{label} artifact: packed output differs from the live "
                                 f"program's by {float((live - packed).abs().max())}")
    hits = sum(golden._word_match_fraction(words, [w for w, _ in found]) * len(words)
               for words, found in zip(expected, results))
    n_words = sum(len(words) for words in expected)
    fraction = hits / n_words
    if fraction < pass_fraction:
        raise AssertionError(f"{label} artifact: fraction {fraction} (pass >= {pass_fraction})")
    return launches, (f"{label} artifact (batch 4, {height}x{width}, refine level "
                      f"{baked['refine_level']}, warp level {baked['warp_level']}): "
                      f"{export_summary(served, path, seconds)}; fraction {fraction:.4f} over "
                      f"{n_words} words, {len(runs)} packed outputs equal to the live program's, "
                      f"launches in the artifact's run {launches}")


def serving_phase(card, golden_images, expected, pipelines, wrappers, pass_fraction,
                  full_pipeline, scenes):
    """Phase 10: the JPEG read, the golden artifacts on both graphs and
    the full-width artifacts at batch 1 and 8 against the live pipeline.
    Returns the launches of the folded golden artifact's run."""
    from keras_ocr_tpu_torch import tools

    decode_ms = []
    for _ in range(5):
        start = time.perf_counter()
        photo = tools.read(SERVING_JPEG)
        decode_ms.append((time.perf_counter() - start) * 1e3)
    digest = hashlib.sha256(photo.tobytes()).hexdigest()
    if photo.shape != (480, 640, 3) or digest != SERVING_JPEG_SHA256:
        raise AssertionError(f"JPEG decode {photo.shape} sha256 {digest}, PIL's is "
                             f"{SERVING_JPEG_SHA256}")
    full_pipeline.recognize([SERVING_JPEG])
    start = time.perf_counter()
    photo_results = full_pipeline.recognize([SERVING_JPEG])
    photo_ms = (time.perf_counter() - start) * 1e3
    check_results(photo_results, 1)
    print(f"serving ({card}): {os.path.relpath(SERVING_JPEG, ROOT)} decoded by path in "
          f"{statistics.median(decode_ms):.2f} ms (median of 5; host CPU {host_cpu()}), "
          f"640x480x3, sha256 equal to PIL's decode; full-width recognize of the path "
          f"{photo_ms:.2f} ms, {len(photo_results[0])} words")

    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    os.makedirs(SERVING_DIR)
    try:
        lines, golden_launches = [], {}
        for label, pipeline in pipelines:
            launches, line = serve_golden(label, pipeline, golden_images, expected, wrappers,
                                          pass_fraction)
            needed = ("cc_sweeps", "cc_keyed_rows_cols") + (
                ("conv_chain", "conv3x3_bias_act") if "folded" in label else ())
            if min(launches[name] for name in needed) <= 0:
                raise AssertionError(f"the {label} artifact skipped a kernel: {launches}")
            golden_launches = launches
            lines.append(line)
        print(f"serving ({card}): " + "; ".join(lines))

        for batch_size, reps in ((1, 10), (8, 5)):
            alone_ms = []
            for rep in range(reps):
                start = time.perf_counter()
                check_results(full_pipeline.recognize((scenes * 2)[rep : rep + batch_size]),
                              batch_size)
                alone_ms.append((time.perf_counter() - start) * 1e3)
            path = os.path.join(SERVING_DIR, f"full_b{batch_size}")
            served, seconds = timed_export(full_pipeline, path, height=480, width=640,
                                           batch_size=batch_size)
            gc.collect()  # the export's traced graphs, before anything is timed
            art_ms, live_ms = [], []
            for rep in range(reps + 1):
                images = (scenes * 2)[rep : rep + batch_size]
                for times, call in ((art_ms, served.recognize), (live_ms, full_pipeline.recognize)):
                    start = time.perf_counter()
                    results = call(images)
                    if rep:  # the first round warms both up
                        times.append((time.perf_counter() - start) * 1e3)
                    check_results(results, batch_size)
            print(f"serving, full width ({card}), 640x480 batch {batch_size}: "
                  f"{export_summary(served, path, seconds)}; recognize p50 (in turns, "
                  f"{reps} each) artifact {statistics.median(art_ms):.2f} ms, live "
                  f"{statistics.median(live_ms):.2f} ms (live before the export "
                  f"{statistics.median(alone_ms):.2f} ms); artifact refine level "
                  f"{served.meta['refine_level']}, warp level {served.meta['warp_level']}")
    finally:
        shutil.rmtree(SERVING_DIR, ignore_errors=True)
    return golden_launches


# Phase 11: training.
TRAIN_LOSS_BAR = 1e-4
# Each gradient leaf of the float64 card step within this share of the
# leaf's largest |g| of the float64 CPU step. In float32 the card's cuDNN
# and CUDA reductions leave its gradients up to ~5e-3 (CRNN) and ~6e-2
# (CRAFT at random init, where the CPU's own float32 step is 4.5e-2 off)
# from the float64 ones, so the float32 gradients are printed, not barred.
TRAIN_GRAD_BAR = 1e-3
# Card leaves whose float64 CPU gradient is rounding noise (zero in exact
# arithmetic: a conv bias a BatchNorm follows) stay below this share of
# the model's largest gradient.
TRAIN_NOISE_BAR = 1e-4
TRAINING_DIR = os.path.join(ROOT, "build", "training")
# Detector width, the (batch, height, width) of the card-vs-CPU CRAFT step
# and of the timed CRAFT steps, and the timed CRNN batches.
TRAIN_CRAFT_WIDTH = 1.0
TRAIN_CRAFT_PARITY = (2, 256, 256)
TRAIN_CRAFT_TIMED = (8, 640, 640)
TRAIN_CRNN_BATCHES = (8, 64)


def tree_leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from tree_leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def gradient_leaves(model, bridge):
    """The model's last gradients as numpy leaves of the JAX tree layout
    (zeros for frozen parameters), through the weight bridge."""
    state = dict(model.state_dict())
    for name, param in model.named_parameters():
        state[name] = param.grad if param.grad is not None else torch.zeros_like(param)
    return dict(tree_leaves(bridge(state)["params"]))


def gradient_errors(model, reference, bridge):
    """({leaf: max|g - g_ref| / max|g_ref|}, the largest |g| of the leaves
    that are rounding noise in the reference, over the reference's largest)."""
    ours, ref = gradient_leaves(model, bridge), gradient_leaves(reference, bridge)
    largest = max(float(np.abs(value).max()) for value in ref.values())
    errors, noise = {}, 0.0
    for path, value in ref.items():
        scale = float(np.abs(value).max())
        if scale <= 1e-9 * largest:
            noise = max(noise, float(np.abs(ours[path]).max()) / largest)
        else:
            errors[path] = float(np.abs(ours[path] - value).max()) / scale
    return errors, noise


def worst(errors):
    leaf = max(errors, key=errors.get)
    return (f"{leaf} at {errors[leaf]:.3e} of its largest |g| "
            f"({sum(e > TRAIN_GRAD_BAR for e in errors.values())}/{len(errors)} leaves over "
            f"{TRAIN_GRAD_BAR})")


def step_parity(what, trainer_cls, make, bridge, batch, **kwargs):
    """One train step from one state on the card and on the CPU, in float32
    and in float64: the float32 losses within TRAIN_LOSS_BAR relative; the
    float64 gradients within TRAIN_GRAD_BAR of each leaf's largest |g|.
    Returns the float32 card trainer (for more steps), its loss and a
    summary with the float32 gradients' distance from the float64 ones."""
    card = make("cuda")
    variables = bridge(card.model)
    cpu, card64, cpu64 = (make(on).load_variables(variables) for on in ("cpu", "cuda", "cpu"))
    for wide in (card64, cpu64):
        wide.model.double()
    trainer = trainer_cls(card, **kwargs)
    loss = trainer.train_step(batch)
    loss_err = loss_parity(what, loss, trainer_cls(cpu, **kwargs).train_step(batch))
    trainer_cls(card64, **kwargs).train_step(batch)
    trainer_cls(cpu64, **kwargs).train_step(batch)
    errors, noise = gradient_errors(card64.model, cpu64.model, bridge)
    if not (max(errors.values()) <= TRAIN_GRAD_BAR and noise <= TRAIN_NOISE_BAR):
        raise AssertionError(f"{what} float64 gradients, card vs CPU: {worst(errors)}; noise "
                             f"leaves {noise:.3e}")
    card32, _ = gradient_errors(card.model, cpu64.model, bridge)
    cpu32, _ = gradient_errors(cpu.model, cpu64.model, bridge)
    summary = (f"loss {loss:.6f} within {loss_err:.3e} relative of the CPU's (bar "
               f"{TRAIN_LOSS_BAR}); float64 gradients, card vs CPU: worst {worst(errors)}, "
               f"noise leaves {noise:.3e} of the largest |g|; float32 gradients against the "
               f"float64 CPU step: card worst {worst(card32)}, CPU worst {worst(cpu32)}")
    return trainer, loss, summary


def loss_parity(what, card_loss, cpu_loss):
    err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if not err <= TRAIN_LOSS_BAR:
        raise AssertionError(f"{what} loss {card_loss} on the card vs {cpu_loss} on the CPU")
    return err


def crnn_batch(rng, size, frames, alphabet_size, width=200):
    """Random crops and labels of 1-20 characters, as ``get_batch_generator``
    gives them."""
    images = rng.rand(size, 31, width, 1).astype(np.float32)
    label_length = rng.randint(1, min(20, frames) + 1, size=(size, 1))
    labels = np.full((size, frames), -1, np.int64)
    for i, n in enumerate(label_length[:, 0]):
        labels[i, :n] = rng.randint(0, alphabet_size, size=n)
    return ((images, labels, np.full((size, 1), frames, np.float64), label_length),
            np.zeros((size, 1)))


def craft_batch(rng, size, height, width):
    """Normalised random images and maps with a text and a link blob each."""
    images = rng.randn(size, height, width, 3).astype(np.float32)
    targets = (rng.rand(size, height // 2, width // 2, 2) * 0.05).astype(np.float32)
    for i in range(size):
        y, x = rng.randint(0, height // 4, size=2)
        targets[i, y : y + height // 8, x : x + width // 4, 0] = 0.9
        targets[i, y + 2 : y + height // 16, x : x + width // 4, 1] = 0.6
    return images, targets


def text_scenes(rng, height=640, width=640):
    """(image, lines) samples for ``Detector.get_batch_generator``: dark
    character rectangles on a light noisy page, in horizontal lines of
    words separated by spaces."""
    while True:
        image = rng.randint(180, 256, (height, width, 3)).astype(np.uint8)
        lines = []
        for top in range(20, height - 60, 60):
            size = rng.randint(16, 40)
            x, line = rng.randint(0, 40), []
            while x + size < width - 10 and len(line) < 24:
                if line and rng.rand() < 0.15:
                    line.append((np.array([[x, top], [x + size // 2, top],
                                           [x + size // 2, top + size], [x, top + size]],
                                          np.float32), " "))
                    x += size // 2
                    continue
                w = int(size * rng.uniform(0.6, 0.9))
                image[top : top + size, x : x + w] = rng.randint(0, 80)
                line.append((np.array([[x, top], [x + w, top], [x + w, top + size],
                                       [x, top + size]], np.float32), "x"))
                x += w + 2
            lines.append(line)
        yield image, lines


def crop_samples(rng, alphabet):
    """(image, text) samples for ``Recognizer.get_batch_generator``."""
    while True:
        text = "".join(rng.choice(list(alphabet), size=rng.randint(3, 11)))
        yield rng.randint(0, 256, (31, 200, 3)).astype(np.uint8), text


def training_phase(card, golden_images, sweep_wrappers):
    """Phase 11: the full-width train steps on the card held against the
    same steps on the CPU, falling losses, OHEM, step and generator times,
    the CTC loss against ``F.ctc_loss``, ``fit`` with the three callbacks
    and ``save_npz``, and ``Detector.detect`` of the trained detector.
    Returns the float32 step ms (CRNN at batch 8 and 64, CRAFT) and the
    CRAFT step's peak GB."""
    from torch.nn import functional as F

    from keras_ocr_tpu_torch import Detector, Recognizer, weights
    from keras_ocr_tpu_torch.models.crnn import DEFAULT_BUILD_PARAMS
    from keras_ocr_tpu_torch.ops.ctc import ctc_loss
    from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer, checkpoint
    from keras_ocr_tpu_torch.train.callbacks import CSVLogger, EarlyStopping, ModelCheckpoint

    device = torch.device("cuda")
    rng = np.random.RandomState(11)
    no_dropout = dict(DEFAULT_BUILD_PARAMS, dropout=0.0)

    # (a) One step on the card against the same step on the CPU from one
    # state, then 19 more on the same batch.
    def recognizer_on(on):
        return Recognizer(weights=None, build_params=no_dropout, device=on, seed=3)

    def detector_on(on):
        return Detector(weights=None, width=TRAIN_CRAFT_WIDTH, device=on, seed=4)

    frames = 48
    batch = crnn_batch(rng, 8, frames, 36)
    trainer, loss, crnn_summary = step_parity("CRNN", RecognizerTrainer, recognizer_on,
                                              weights.crnn_variables, batch)
    crnn_losses = [loss] + [trainer.train_step(batch) for _ in range(19)]

    images, targets = craft_batch(rng, *TRAIN_CRAFT_PARITY)
    detector_trainer, loss, craft_summary = step_parity(
        "CRAFT", DetectorTrainer, detector_on, weights.craft_variables, (images, targets))
    detector = detector_trainer.detector
    craft_losses = [loss] + [detector_trainer.train_step((images, targets)) for _ in range(19)]
    ohem_loss = DetectorTrainer(Detector(weights=None, width=TRAIN_CRAFT_WIDTH, device=device,
                                         seed=5),
                                loss="ohem").train_step((images, targets))
    for what, series in (("CRNN", crnn_losses), ("CRAFT", craft_losses)):
        if not (np.isfinite(series).all() and series[-1] < series[0]):
            raise AssertionError(f"{what} loss on a fixed batch did not fall: {series}")
    if not np.isfinite(ohem_loss):
        raise AssertionError(f"OHEM loss {ohem_loss}")
    print(f"training ({card}), card vs CPU from one state: full-width CRNN (31x200, filters "
          f"64..512, STN at its identity start, dropout 0) batch 8: {crnn_summary}")
    print(f"training ({card}), card vs CPU from one state: CRAFT width {TRAIN_CRAFT_WIDTH}, "
          f"{'x'.join(map(str, TRAIN_CRAFT_PARITY))}: {craft_summary}")
    print(f"training ({card}), 20 steps on a fixed batch: CRNN (RMSprop 1e-3) "
          f"{crnn_losses[0]:.4f} -> {crnn_losses[-1]:.4f}; CRAFT (Adam 1e-3, MSE) "
          f"{craft_losses[0]:.6f} -> {craft_losses[-1]:.6f}; OHEM step loss {ohem_loss:.6f}")

    # (b) Times: CUDA events around whole train steps (upload, forward,
    # backward, optimiser, loss fetch), medians of 10 after a warm-up.
    timing = Recognizer(weights=None, device=device, seed=6)  # dropout 0.25, as trained
    timing_trainer = RecognizerTrainer(timing)
    if timing.max_string_length() != frames:
        raise AssertionError(f"{timing.max_string_length()} CTC frames, not {frames}")
    step_ms = {}
    for size in TRAIN_CRNN_BATCHES:
        batch = crnn_batch(rng, size, frames, len(timing.alphabet))
        step_ms["crnn", size] = cuda_median_ms(lambda: timing_trainer.train_step(batch),
                                               runs=10)
    size_craft, height, width = TRAIN_CRAFT_TIMED
    generator = detector.get_batch_generator(text_scenes(rng, height, width),
                                             batch_size=size_craft)
    batches, generator_ms = [], []
    for _ in range(3):
        start = time.perf_counter()
        batches.append(next(generator))
        generator_ms.append((time.perf_counter() - start) * 1e3)
    turn = iter(range(1 << 30))
    torch.cuda.reset_peak_memory_stats()
    step_ms["craft"] = cuda_median_ms(
        lambda: detector_trainer.train_step(batches[next(turn) % len(batches)]), runs=10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Forwards alone, in training mode with autograd recording, and the
    # CTC loss forward + backward against F.ctc_loss at each CRNN batch.
    forward_ms = {}
    dropout_masks = torch.Generator(device="cuda").manual_seed(8)
    timing.model.train()
    for size in TRAIN_CRNN_BATCHES:
        x = torch.rand((size, 31, 200, 1), device=device)
        forward_ms["crnn", size] = cuda_median_ms(
            lambda: timing.model(x, return_logits=True, generator=dropout_masks), runs=10)
    timing.model.eval()
    x = torch.randn((size_craft, height, width, 3), device=device)
    detector.model.train()
    forward_ms["craft"] = cuda_median_ms(lambda: detector.model(x), runs=10)
    detector.model.eval()
    del x

    ctc_ms, library_ms, ctc_err = {}, {}, 0.0
    for ctc_batch in TRAIN_CRNN_BATCHES:
        logits = torch.randn((ctc_batch, frames, len(timing.alphabet) + 1), device=device,
                             generator=torch.Generator(device="cuda").manual_seed(7))
        _, labels, input_length, label_length = [
            torch.as_tensor(a, device=device)
            for a in crnn_batch(rng, ctc_batch, frames, 36)[0]]
        input_length = input_length.to(torch.int64).reshape(-1)
        label_length = label_length.reshape(-1)

        def port_ctc():
            x = logits.detach().requires_grad_()
            loss = ctc_loss(x, labels, input_length, label_length)
            loss.sum().backward()
            return loss.detach()

        def library_ctc():
            x = logits.detach().requires_grad_()
            loss = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1), labels.clamp(min=0),
                              input_length, label_length, blank=logits.shape[-1] - 1,
                              reduction="none")
            loss.sum().backward()
            return loss.detach()

        ctc_err = max(ctc_err, float(((port_ctc() - library_ctc()).abs()
                                      / library_ctc().abs()).max()))
        ctc_ms[ctc_batch] = cuda_median_ms(port_ctc, runs=10)
        library_ms[ctc_batch] = cuda_median_ms(library_ctc, runs=10)
    if not ctc_err <= TRAIN_LOSS_BAR:
        raise AssertionError(f"ctc_loss vs F.ctc_loss: {ctc_err}")
    crnn_ms = ", ".join(f"batch {b} {step_ms['crnn', b]:.3f} ms (forward "
                        f"{forward_ms['crnn', b]:.3f}, CTC forward + backward {ctc_ms[b]:.3f} "
                        f"vs F.ctc_loss {library_ms[b]:.3f})" for b in TRAIN_CRNN_BATCHES)
    float32_steps = {"crnn 8": step_ms["crnn", 8], "crnn 64": step_ms["crnn", 64],
                     "craft": step_ms["craft"], "craft peak GB": peak_gb}
    print(f"training ({card}): train step, median of 10: CRNN {crnn_ms}; CRAFT "
          f"{height}x{width} batch {size_craft} (get_batch_generator batches) "
          f"{step_ms['craft']:.3f} ms (forward {forward_ms['craft']:.3f}), peak memory "
          f"{peak_gb:.3f} GB; one generator batch of {size_craft} (compute_maps on the host) "
          f"{statistics.median(generator_ms):.2f} ms (median of 3; host CPU {host_cpu()}); "
          f"the port's CTC losses within {ctc_err:.3e} relative of F.ctc_loss")

    # (c) fit with the three callbacks, then save_npz.
    shutil.rmtree(TRAINING_DIR, ignore_errors=True)
    try:
        log = os.path.join(TRAINING_DIR, "log.csv")
        os.makedirs(TRAINING_DIR)
        history = timing_trainer.fit(
            timing.get_batch_generator(crop_samples(rng, timing.alphabet), batch_size=8),
            steps_per_epoch=2, epochs=2, seed=1, callbacks=[
                EarlyStopping(restore_best_weights=True),
                ModelCheckpoint(os.path.join(TRAINING_DIR, "best")), CSVLogger(log)])
        path = checkpoint.save_npz(os.path.join(TRAINING_DIR, "recognizer.npz"),
                                   timing_trainer.variables)
        with open(log) as f:
            rows = len(f.read().strip().splitlines())
        restored = dict(tree_leaves(checkpoint.restore_npz(path)))
        if (len(history) != 2 or rows != 3 or timing.model.training
                or not os.path.isfile(os.path.join(TRAINING_DIR, "best.npz"))
                or not all(np.array_equal(restored[k], v)
                           for k, v in tree_leaves(timing_trainer.variables))):
            raise AssertionError(f"fit: history {history}, {rows} CSV rows")
        print(f"training ({card}): fit 2 epochs x 2 steps (batch 8, EarlyStopping, "
              f"ModelCheckpoint, CSVLogger): epoch losses {[round(h, 4) for h in history]}; "
              f"save_npz {os.path.getsize(path) / 1e6:.2f} MB, restored equal")
    finally:
        shutil.rmtree(TRAINING_DIR, ignore_errors=True)

    # (d) The trained detector reads a golden scene through the sweep kernel.
    for wrapper in sweep_wrappers.values():
        wrapper.launches = 0
    boxes = detector.detect([golden_images[0]])
    launches = {name: wrapper.launches for name, wrapper in sweep_wrappers.items()}
    if len(boxes) != 1 or min(launches.values()) <= 0:
        raise AssertionError(f"trained detector's detect: {len(boxes)} results, {launches}")
    print(f"training ({card}): Detector.detect of the trained detector on one golden scene: "
          f"{len(boxes[0])} boxes, launches {launches}")
    return float32_steps


# Phase 12: weights. Files go to build/weights, removed at the end.
WEIGHTS_DIR = os.path.join(ROOT, "build", "weights")
# The twin against the port's CRAFT on the card.
TWIN_BAR = 1e-4
OTHER_ALPHABET = "abcdefghij"


def median_seconds(fn, runs=3):
    """(median seconds, last result) of ``runs`` calls of ``fn``."""
    times, result = [], None
    for _ in range(runs):
        start = time.perf_counter()
        result = fn()
        times.append(time.perf_counter() - start)
    return statistics.median(times), result


def by_path_and_array(pipeline, path, image, runs=3):
    """``pipeline.recognize`` of one file by path and as its decoded array,
    in turns, each call between ``torch.cuda.synchronize``: (median s by
    path, median s as the array, the last result by path, the last as the
    array)."""
    calls = {"path": [], "array": []}
    results = {}
    for _ in range(runs):
        for key, source in (("path", path), ("array", image)):
            torch.cuda.synchronize()
            start = time.perf_counter()
            results[key] = pipeline.recognize([source])
            torch.cuda.synchronize()
            calls[key].append(time.perf_counter() - start)
    return (statistics.median(calls["path"]), statistics.median(calls["array"]),
            results["path"], results["array"])


def same_words_and_boxes(a, b) -> bool:
    """Two ``recognize`` results of one image: the same words and boxes."""
    return [w for w, _ in a] == [w for w, _ in b] and all(
        np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))


def same_tree(what, got, want, prefix=""):
    """Every leaf of ``got`` bit for bit equal to ``want``'s."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)} at {prefix!r}")
    for key, value in want.items():
        if isinstance(value, dict):
            same_tree(what, got[key], value, f"{prefix}/{key}")
        elif (np.asarray(got[key]).dtype != value.dtype
              or np.asarray(got[key]).tobytes() != np.ascontiguousarray(value).tobytes()):
            raise AssertionError(f"{what}: {prefix}/{key} differs")


def exactly(what, out, ref):
    if out.shape != ref.shape or not torch.equal(out, ref):
        err = float((out - ref).abs().max()) if out.shape == ref.shape else None
        raise AssertionError(f"{what}: not identical (max |diff| {err})")


def registry_entry(path):
    """A registry entry for ``path``: its own sha256 and an unreachable URL."""
    name = os.path.basename(path)
    from keras_ocr_tpu_torch import tools

    return {"url": f"https://unreachable.invalid/{name}", "filename": name,
            "sha256": tools.sha256sum(path)}


def read_all_h5(h5, path):
    """Open ``path`` with the port's reader and read every dataset; the
    bytes read."""
    arrays = []
    h5.File(path).visititems(
        lambda _, node: arrays.append(np.asarray(node)) if isinstance(node, h5.Dataset) else None)
    return sum(a.nbytes for a in arrays)


def weights_phase(card, scenes, sweep_wrappers, conv_wrappers):
    """Phase 12: the published-weight formats on the card. The full-width
    CRAFT (seeded BatchNorm statistics) written as ``.h5``, ``.pth`` and a
    legacy ``.pth`` in clovaai's form, and the full-width CRNN as top and
    notop ``.h5``, each resolved through ``download_pretrained`` from
    ``build/weights`` with ``urlopen`` refused, read back bit for bit, and
    loaded into ``Detector`` / ``Recognizer`` by name: heatmaps and softmax
    identical to models given the same tree; the ``.pth``-loaded detector's
    full-width ``recognize`` launches the sweep kernel (and the conv kernel
    when folded); the torch twin agrees with the port's CRAFT; sizes,
    times and the HDF5 reader's rate; then the published files, if
    vendored."""
    import urllib.request

    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, h5, tools, weights
    from keras_ocr_tpu_torch.detection import build_torch_model

    device = torch.device("cuda")
    published_dir = weights.vendored_weights_dir()
    published = {
        "detector": dict(weights.DETECTOR_PRETRAINED),
        "recognizer": weights.RECOGNIZER_PRETRAINED["kurapan"],
    }
    urls = []

    def refuse(url, *args, **kwargs):
        urls.append(url)
        raise OSError("phase 12 resolves weight files offline")

    saved = (urllib.request.urlopen, os.environ.get("KERAS_OCR_TPU_VENDORED_WEIGHTS"),
             torch.backends.cudnn.deterministic)
    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    os.makedirs(WEIGHTS_DIR)
    urllib.request.urlopen = refuse
    os.environ["KERAS_OCR_TPU_VENDORED_WEIGHTS"] = WEIGHTS_DIR
    # Identical heatmaps and softmax: the same algorithms for both models.
    torch.backends.cudnn.deterministic = True
    sizes, write_s, read_s, build_s = {}, {}, {}, {}
    try:
        # (1) CRAFT: three files, each resolved offline, read back, loaded.
        reference = Detector(weights=None, device=device, seed=0)
        seed_batch_norm(reference.model, seed=2)
        craft = weights.craft_variables(reference.model)
        folded_reference = Detector(weights=None, fold_bn=True, device=device).load_variables(
            craft)

        def legacy_pth(path):
            state = {f"module.{key}": torch.from_numpy(np.ascontiguousarray(value))
                     for key, value in weights.craft_variables_to_torch_state_dict(craft).items()
                     if not key.endswith("num_batches_tracked")}
            torch.save(state, path, _use_new_zipfile_serialization=False)
            return path

        craft_files = {}
        for label, name, write in (
                ("h5", "craft.h5", lambda p: weights.craft_variables_to_h5(craft, p)),
                ("pth", "craft.pth", lambda p: weights.save_craft_torch_checkpoint(craft, p)),
                ("legacy pth", "craft_legacy.pth", legacy_pth)):
            path = os.path.join(WEIGHTS_DIR, name)
            write_s[label], _ = median_seconds(lambda: write(path))
            entry = registry_entry(path)
            if weights.download_pretrained(entry) != path:
                raise AssertionError(f"{label}: download_pretrained did not find {path}")
            read_s[label], tree = median_seconds(lambda: weights.load_craft_weights(path))
            same_tree(f"CRAFT {label} read back", tree, craft)
            sizes[label] = os.path.getsize(path) / 1e6
            craft_files[label] = (path, entry)
        with open(craft_files["legacy pth"][0], "rb") as f:
            if f.read(2) == b"PK":
                raise AssertionError("the legacy .pth was written as a zip archive")

        x = torch.randn((1, 480, 640, 3), generator=torch.Generator(device="cuda").manual_seed(7),
                        device="cuda")
        with torch.inference_mode():
            ref_heatmaps = {False: reference.model(x), True: folded_reference.model(x)}
        detectors = {}
        for label, (path, entry) in craft_files.items():
            key = ("clovaai_general", label != "h5")
            weights.DETECTOR_PRETRAINED[key] = entry
            for fold in (False, True):
                seconds, detector = median_seconds(lambda: Detector(
                    load_from_torch=key[1], fold_bn=fold, device=device))
                build_s[f"Detector {label}" + (", folded" if fold else "")] = seconds
                with torch.inference_mode():
                    exactly(f"heatmaps, Detector from {label} (fold_bn={fold})",
                            detector.model(x), ref_heatmaps[fold])
                detectors[label, fold] = detector
        print(f"weights ({card}): CRAFT (width 1.0, seeded BatchNorm statistics) written as "
              f".h5 / .pth / legacy .pth, each resolved offline by download_pretrained, read "
              f"back bit for bit, and Detector(weights=...) heatmaps at 480x640 identical to "
              f"the tree's, standard and fold_bn=True")

        # The .pth-loaded detectors read the golden scenes at 640x480.
        recognizer = Recognizer(weights=None, device=device, seed=1)
        for fold in (False, True):
            wrappers = {**sweep_wrappers, **(conv_wrappers if fold else {})}
            for wrapper in {**sweep_wrappers, **conv_wrappers}.values():
                wrapper.launches = 0
            pipeline = Pipeline(detector=detectors["pth", fold], recognizer=recognizer, scale=2)
            check_results(pipeline.recognize(scenes[:4]), 4)
            launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
            if min(launches.values()) <= 0:
                raise AssertionError(f"the .pth-loaded detector skipped a kernel: {launches}")
            print(f"weights: full-width recognize of 4 golden scenes (640x480) through the "
                  f".pth-loaded detector{' (fold_bn=True)' if fold else ''}: launches {launches}")

        # (2) CRNN: top and notop files.
        crnn_reference = Recognizer(weights=None, device=device, seed=3)
        seed_batch_norm(crnn_reference.model, seed=4)
        with torch.no_grad():
            stn = crnn_reference.model.stn.dense2  # off the identity: the sampler moves
            stn.weight.copy_(torch.randn(stn.weight.shape, generator=torch.Generator()
                                         .manual_seed(5)) * 0.02)
            stn.bias.copy_(torch.tensor([0.9, 0.08, 0.05, -0.06, 1.1, 0.03]))
        crnn = weights.crnn_variables(crnn_reference.model)
        notop_tree = {"params": {k: v for k, v in crnn["params"].items() if k != "fc_12"},
                      "batch_stats": crnn["batch_stats"]}
        crnn_entries = {}
        for label, include_top in (("top", True), ("notop", False)):
            path = os.path.join(WEIGHTS_DIR, f"crnn_{label}.h5")
            write_s[f"CRNN {label}"], _ = median_seconds(
                lambda: weights.crnn_variables_to_h5(crnn, path, include_top=include_top))
            crnn_entries[label] = registry_entry(path)
            if weights.download_pretrained(crnn_entries[label]) != path:
                raise AssertionError(f"CRNN {label}: download_pretrained did not find {path}")
            read_s[f"CRNN {label}"], tree = median_seconds(
                lambda: weights.crnn_variables_from_h5(path, include_top=include_top))
            same_tree(f"CRNN {label} read back", tree, crnn if include_top else notop_tree)
            sizes[f"CRNN {label}"] = os.path.getsize(path) / 1e6
        weights.RECOGNIZER_PRETRAINED["kurapan"] = {"weights": crnn_entries}
        build_s["Recognizer top"], from_file = median_seconds(lambda: Recognizer(device=device))
        crops = torch.rand((8, 31, 200, 1), generator=torch.Generator(device="cuda").manual_seed(8),
                           device="cuda")
        tree_loaded = Recognizer(weights=None, device=device).load_variables(crnn)
        with torch.inference_mode():
            exactly("softmax, Recognizer from the top file", from_file.model(crops),
                    tree_loaded.model(crops))
        build_s["Recognizer notop"], other = median_seconds(
            lambda: Recognizer(alphabet=OTHER_ALPHABET, device=device))
        own = Recognizer(OTHER_ALPHABET, None, device=device).model.fc_12
        exactly("notop recognizer's own fc_12", other.model.fc_12.weight, own.weight)
        same_tree("notop recognizer's backbone", {
            k: v for k, v in weights.crnn_variables(other.model)["params"].items()
            if k != "fc_12"}, notop_tree["params"])
        print(f"weights ({card}): CRNN (DEFAULT_BUILD_PARAMS, STN) written as top and notop "
              f".h5, resolved offline, read back bit for bit; Recognizer() softmax on 8 crops "
              f"identical to the tree's; Recognizer(alphabet={OTHER_ALPHABET!r}) loads the "
              f"notop backbone and keeps its own fc_12 {tuple(other.model.fc_12.weight.shape)}")

        # (3) The torch twin against the port's CRAFT at 480x640.
        twin = build_torch_model(craft_files["pth"][0])
        twin.load_state_dict({k: v.to(device) for k, v in twin.state_dict_.items()})
        with torch.inference_mode():
            twin_out = twin(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        err = check_close("twin vs the port's CRAFT", twin_out, ref_heatmaps[False], TWIN_BAR)
        print(f"weights ({card}): torch twin of CRAFT from the .pth within {err:.3e} of the "
              f"port's CRAFT at 480x640 (max|ref| {float(ref_heatmaps[False].abs().max()):.3e}; "
              f"bar {TWIN_BAR} * max(1, max|ref|))")

        # (4) Sizes, times, the HDF5 reader's rate.
        h5_path = craft_files["h5"][0]
        reader_s, nbytes = median_seconds(lambda: read_all_h5(h5, h5_path))
        print(f"weights ({card}): file MB " + ", ".join(
            f"{k} {v:.3f}" for k, v in sizes.items()))
        print(f"weights ({card}): write s (median of 3) " + ", ".join(
            f"{k} {v:.3f}" for k, v in write_s.items()))
        print(f"weights ({card}): read+convert s (median of 3) " + ", ".join(
            f"{k} {v:.3f}" for k, v in read_s.items()))
        print(f"weights ({card}): construction s (median of 3) " + ", ".join(
            f"{k} {v:.3f}" for k, v in build_s.items()))
        print(f"weights ({card}): HDF5 reader {sizes['h5'] / reader_s:.1f} MB/s "
              f"({nbytes / 1e6:.3f} MB of datasets in {reader_s:.3f} s, CRAFT .h5, median "
              f"of 3; host CPU {host_cpu()})")
        if urls:
            raise AssertionError(f"phase 12 reached for the network: {urls}")
    finally:
        urllib.request.urlopen = saved[0]
        if saved[1] is None:
            os.environ.pop("KERAS_OCR_TPU_VENDORED_WEIGHTS", None)
        else:
            os.environ["KERAS_OCR_TPU_VENDORED_WEIGHTS"] = saved[1]
        torch.backends.cudnn.deterministic = saved[2]
        weights.DETECTOR_PRETRAINED.update(published["detector"])
        weights.RECOGNIZER_PRETRAINED["kurapan"] = published["recognizer"]
        shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)

    # The published files, where they are vendored.
    needed = [weights.DETECTOR_PRETRAINED["clovaai_general", False],
              weights.RECOGNIZER_PRETRAINED["kurapan"]["weights"]["top"]]
    missing = [entry["filename"] for entry in needed
               if not os.path.isfile(os.path.join(published_dir, entry["filename"]))
               or tools.sha256sum(os.path.join(published_dir, entry["filename"]))
               != entry["sha256"]]
    if missing:
        print(f"weights: published files not in {os.path.relpath(published_dir, ROOT)}/: "
              f"{', '.join(missing)}; Pipeline() with the default weights not run")
        return
    pipeline = Pipeline()
    words = [word for word, _ in pipeline.recognize([SERVING_JPEG])[0]]
    print(f"weights ({card}): Pipeline() with the published weights reads "
          f"{os.path.relpath(SERVING_JPEG, ROOT)}: {words}")


# Phase 13: the EfficientNet backbones. Their ImageNet files are looked up
# offline; the lookup's cache goes here, removed at the end.
EFFICIENTNET_CACHE = os.path.join(ROOT, "build", "efficientnet_cache")


@contextlib.contextmanager
def offline(cache_dir=EFFICIENTNET_CACHE):
    """Weight lookups with ``urllib.request.urlopen`` refused (any call is
    recorded and fails) and the download cache in ``cache_dir``; yields the
    list of refused URLs."""
    import urllib.request

    urls = []

    def refuse(url, *args, **kwargs):
        urls.append(url)
        raise OSError("weight files are resolved offline here")

    saved = urllib.request.urlopen, os.environ.get("KERAS_OCR_TPU_CACHE_DIR")
    urllib.request.urlopen = refuse
    os.environ["KERAS_OCR_TPU_CACHE_DIR"] = cache_dir
    try:
        yield urls
    finally:
        urllib.request.urlopen = saved[0]
        if saved[1] is None:
            os.environ.pop("KERAS_OCR_TPU_CACHE_DIR", None)
        else:
            os.environ["KERAS_OCR_TPU_CACHE_DIR"] = saved[1]
        shutil.rmtree(cache_dir, ignore_errors=True)


# The CRAFT forwards timed in phase 13 beside the VGG graph's; the
# quantiles of the random B0 heatmaps that set detect's text and link
# thresholds, tried in turn until no image has more components than the
# device cap's ceiling (random weights, so the heatmaps' texture depends
# on torch's generator), and its detection threshold; the ImageNet file
# phase 13 reads if it is vendored.
EFFICIENTNET_TIMED = ("efficientnetb0", "efficientnetb3", "efficientnetb7")
# The CRAFT forwards timed at every batch 1-8, and the most time per image
# any batch may take, as a multiple of batch 1's.
BATCH_SWEPT = ("vgg", "efficientnetb0")
BATCH_SWEEP_BAR = 2.0
DETECT_QUANTILES = ((0.9, 0.95), (0.8, 0.9), (0.7, 0.9), (0.6, 0.9), (0.5, 0.9))
DETECT_QUANTILE = 0.97
IMAGENET_B0 = os.path.join(ROOT, "weights_pretrained", "efficientnetb0_notop.h5")


def efficientnet_detector(name, device, seed=0, compute_dtype=torch.float32):
    """``Detector(weights=None, backbone_name=name)`` with the network
    refused; (detector, whether it warned that the ImageNet file is
    missing)."""
    from keras_ocr_tpu_torch import Detector

    with offline(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        detector = Detector(weights=None, backbone_name=name, compute_dtype=compute_dtype,
                            device=device, seed=seed)
    return detector, any("ImageNet initialization" in str(w.message) for w in caught)


def quantile_thresholds(heatmaps):
    """``detect``'s thresholds at quantiles of (B, H, W, 2) ``heatmaps``:
    the first text and link pair of ``DETECT_QUANTILES`` under which no
    image has more components than the device cap's ceiling. Returns
    ((text, link) quantiles, thresholds, components per image)."""
    from scipy import ndimage

    from keras_ocr_tpu_torch import detection

    for q_text, q_link in DETECT_QUANTILES:
        thresholds = dict(
            text_threshold=float(np.quantile(heatmaps[..., 0], q_text)),
            link_threshold=float(np.quantile(heatmaps[..., 1], q_link)),
            detection_threshold=float(np.quantile(heatmaps[..., 0], DETECT_QUANTILE)))
        counts = [ndimage.label((h[..., 0] > thresholds["text_threshold"])
                                | (h[..., 1] > thresholds["link_threshold"]))[1]
                  for h in heatmaps]
        if max(counts) <= detection.MAX_COMPONENTS_CEILING:
            return (q_text, q_link), thresholds, counts
    raise AssertionError(f"no quantiles in {DETECT_QUANTILES} keep the components "
                         f"under the cap: {counts}")


def efficientnet_phase(card, scenes, vgg, recognizer, sweep_wrappers):
    """Phase 13: the EfficientNet CRAFT on the card. Returns the sweep
    kernel's launches on its pipeline path."""
    from keras_ocr_tpu_torch import Pipeline, detection, weights
    from keras_ocr_tpu_torch.ops.image import compute_input
    from keras_ocr_tpu_torch.train import DetectorTrainer
    from keras_ocr_tpu_torch.weights.efficientnet import (
        efficientnet_variables_from_h5, graft_backbone_variables)

    device = torch.device("cuda")
    detector, warned = efficientnet_detector("efficientnetb0", device)
    if warned:
        seed_batch_norm(detector.model, seed=2)
    print(f"efficientnet ({card}): Detector(weights=None, backbone_name='efficientnetb0') "
          f"with the network refused: " + ("ImageNet file absent, warned, random backbone"
                                           if warned else "ImageNet backbone grafted"))

    # (1) The pipeline on the B0 detector: the same device program and kernels.
    pipeline = Pipeline(detector=detector, recognizer=recognizer, scale=2)
    for wrapper in sweep_wrappers.values():
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        check_results(pipeline.recognize([scenes[0]]), 1)
    enqueue_without_sync(pipeline, scenes[:8])
    p50, images_per_s = time_pipeline(pipeline, scenes)
    launches = {name: wrapper.launches for name, wrapper in sweep_wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"efficientnet ({card}): B0 pipeline, device program of 8 images enqueued with no "
          f"host synchronisation; recognize p50 {p50:.2f} ms (640x480, scale 2, 10 images), "
          f"recognize_many {images_per_s:.2f} images/s (32 images, batch 8), peak memory "
          f"{peak_gb:.3f} GB; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the EfficientNet path was never launched: {launches}")

    # (2) Detector.detect at thresholds set by the random heatmaps' own
    # quantiles (near 0.5 everywhere, they would form one component or none
    # at the defaults). Its noise blobs are irregular, where the device
    # path's 36-angle rectangle bank and the oracle's exact minimum-area
    # rectangle part by more than phase 8's 3 px on text-like blobs; so the
    # boxes are held to the CPU run of the same device path on the card's
    # heatmaps (phase 8's 1e-3 px), and to the oracle in number only.
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # detect's forward = this one
    try:
        batch = torch.from_numpy(np.stack(scenes[:8])).to(device)
        with torch.inference_mode():
            heatmaps = detector.model(compute_input(batch)).cpu().numpy()
        (q_text, q_link), thresholds, counts = quantile_thresholds(heatmaps)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            start = time.perf_counter()
            found = detector.detect(scenes[:8], **thresholds)
            detect_ms = (time.perf_counter() - start) * 1e3
    finally:
        torch.backends.cudnn.deterministic = saved
    if caught:
        raise AssertionError(f"Detector.detect warned: {[str(w.message) for w in caught]}")
    cpu = efficientnet_detector("efficientnetb0", "cpu")[0]
    cpu.model = FixedCraft(torch.from_numpy(heatmaps[:2]))
    for image, (got, want) in enumerate(zip(found, cpu.detect(scenes[:2], **thresholds))):
        err = float(np.abs(got - want).max()) if len(got) else 0.0
        if got.shape != want.shape or not err <= REFINE_BAR:
            raise AssertionError(f"B0 detect image {image}: card vs CPU {got.shape} / "
                                 f"{want.shape}, {err} px")
    oracle_px = []
    for image, (got, want) in enumerate(zip(found, detection.getBoxes(heatmaps, **thresholds))):
        if len(got) != len(want):
            raise AssertionError(f"B0 detect image {image}: {len(got)} boxes, oracle {len(want)}")
        oracle_px.append(float(np.abs(canonical(got) - canonical(want)).max()) if len(got)
                         else 0.0)
    print(f"efficientnet ({card}): B0 Detector.detect of 8 scenes (480x640) at the heatmaps' "
          f"quantiles {q_text} / {q_link} / {DETECT_QUANTILE} ("
          f"{', '.join(f'{k} {v:.5f}' for k, v in thresholds.items())}; {counts} components): "
          f"{[len(b) for b in found]} boxes, no host fallback, {detect_ms:.1f} ms; the first "
          f"2 images within {REFINE_BAR} px of the CPU run; box counts equal to getBoxes', "
          f"largest distance per image {[round(e, 2) for e in oracle_px]} px")
    del pipeline, heatmaps, batch

    # (3) CRAFT forwards at 960x1280 beside the VGG graph's.
    forward_ms, forward_gb = {}, {}
    models = {"vgg": vgg.model}
    for name in EFFICIENTNET_TIMED:
        models[name] = detector.model if name == "efficientnetb0" else efficientnet_detector(
            name, device)[0].model
    # VGG and B0 at every batch 1-8 (medians of 5 between 1 and 8): no
    # batch may take more than BATCH_SWEEP_BAR x batch 1's time per image
    # (cuDNN's float32 FFT pick took 14x at batch 2, PerImageConv2d).
    with torch.inference_mode():
        for batch_size in range(1, 9):
            x = torch.randn((batch_size, 960, 1280, 3), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(batch_size))
            for name, model in models.items():
                if batch_size not in (1, 8) and name not in BATCH_SWEPT:
                    continue
                torch.cuda.reset_peak_memory_stats()
                forward_ms[name, batch_size] = cuda_median_ms(
                    lambda: model(x), runs=10 if batch_size in (1, 8) else 5)
                forward_gb[name, batch_size] = torch.cuda.max_memory_allocated() / 1e9
            del x
    print(f"efficientnet ({card}): CRAFT forward at 960x1280, float32, median of 10 (peak "
          f"GB): " + "; ".join(
              f"{name} batch {b} {forward_ms[name, b]:.3f} ms ({forward_gb[name, b]:.2f})"
              for b in (1, 8) for name in models))
    for name in BATCH_SWEPT:
        per_image = {b: forward_ms[name, b] / b for b in range(1, 9)}
        print(f"efficientnet ({card}): {name} CRAFT forward at 960x1280, batch 1-8, ms (per "
              "image; per image / batch 1's): " + ", ".join(
                  f"b{b} {forward_ms[name, b]:.3f} ({per_image[b]:.3f}; "
                  f"{per_image[b] / per_image[1]:.2f})" for b in range(1, 9)))
        slow = [b for b in range(2, 9) if per_image[b] > BATCH_SWEEP_BAR * per_image[1]]
        if slow:
            raise AssertionError(f"{name} CRAFT forward at batches {slow} exceeds "
                                 f"{BATCH_SWEEP_BAR}x batch 1's time per image")
    for name in EFFICIENTNET_TIMED[1:]:
        del models[name]
    gc.collect()
    torch.cuda.empty_cache()

    # (4) Training: card vs CPU from one state, then three steps at 640x640.
    rng = np.random.RandomState(13)

    def b0_on(on):
        return efficientnet_detector("efficientnetb0", on, seed=4)[0]

    images, targets = craft_batch(rng, *TRAIN_CRAFT_PARITY)
    _, _, summary = step_parity("CRAFT B0", DetectorTrainer, b0_on, weights.craft_variables,
                                (images, targets))
    print(f"efficientnet ({card}), card vs CPU from one state: B0 CRAFT "
          f"{'x'.join(map(str, TRAIN_CRAFT_PARITY))}: {summary}")
    trainer = DetectorTrainer(b0_on(device))
    size, height, width = TRAIN_CRAFT_TIMED
    step_batch = craft_batch(rng, size, height, width)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(step_batch))
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"B0 CRAFT loss on a fixed batch did not fall: {losses}")
    print(f"efficientnet ({card}): B0 DetectorTrainer, {size}x{height}x{width} (Adam 1e-3, "
          f"MSE), 3 steps on one batch: losses {[round(l, 6) for l in losses]}, step ms "
          f"{[round(t, 3) for t in step_ms]} (the first with cuDNN's set-up), peak memory "
          f"{peak_gb:.3f} GB")
    del trainer

    # (5) The ImageNet file, where it is vendored.
    if not os.path.isfile(IMAGENET_B0):
        print(f"efficientnet: {os.path.relpath(IMAGENET_B0, ROOT)} absent; the ImageNet "
              "backbone was not read")
        return launches
    backbone = efficientnet_variables_from_h5(IMAGENET_B0, "efficientnetb0")
    detector.load_variables(graft_backbone_variables(weights.craft_variables(detector.model),
                                                     backbone))
    with torch.inference_mode():
        x = compute_input(torch.from_numpy(np.stack(scenes[:2])).to(device))
        taps = detector.model.basenet(x.permute(0, 3, 1, 2).contiguous())
    print(f"efficientnet ({card}): {os.path.relpath(IMAGENET_B0, ROOT)} read; taps of 2 "
          "scenes (mean, std): " + ", ".join(
              f"s{i} {float(t.mean()):.4f} {float(t.std()):.4f}" for i, t in enumerate(taps, 1)))
    return launches


# Phase 14: data. The offline dataset cache goes to build/data, removed at
# the end; the committed fixtures it is made of, with the sha256 of PIL's RGB
# decode of each (tests/test_torch_tools.py asserts the same values).
DATA_DIR = os.path.join(ROOT, "build", "data")
DATA_FIXTURES = {
    "progressive.jpg": "c0adb0d001a6217014b32289dbbfc0b1e3e218bc49d92e2d1eab662f007c3e55",
    "interlaced.png": "0f3f1d71318e7985d8194f853fd77ac71aab2c8b1608d14fda74dfe7fdba36b9",
}
# The loaders' offline counts: ICDAR 2013 images and GT files, BornDigital
# train images (its gt.txt makes 3568 files).
ICDAR_2013_COUNT = 229
BORN_DIGITAL_TRAIN = 3567
DATA_STEPS = 3
DATA_BATCH = 8


def fixture_path(name):
    return os.path.join(ROOT, "tests", "fixtures", name)


def place(source, target):
    """``target`` as a hard link to ``source`` (a copy where links fail)."""
    try:
        os.link(source, target)
    except OSError:
        shutil.copyfile(source, target)


def data_cache(root, words):
    """The ICDAR 2013 detector set and the BornDigital train set in the
    layouts their loaders take offline, made of the committed fixtures:
    ICDAR images alternate the baseline and the progressive JPEG, each with
    a GT file of 1-3 seeded words whose character boxes lie inside the
    image; BornDigital images are the interlaced PNG, labelled with words."""
    rng = np.random.RandomState(14)
    images = os.path.join(root, "icdar2013", "Challenge2_Training_Task12_Images")
    gts = os.path.join(root, "icdar2013", "Challenge2_Training_Task2_GT")
    train = os.path.join(root, "borndigital", "train")
    for folder in (images, gts, train):
        os.makedirs(folder)
    for i in range(ICDAR_2013_COUNT):
        progressive = i % 2 == 1
        place(fixture_path("progressive.jpg" if progressive else "test_image.jpg"),
              os.path.join(images, f"{100 + i}.jpg"))
        width, height = (320, 240) if progressive else (640, 480)
        rows = []
        for _ in range(rng.randint(1, 4)):
            word = words[rng.randint(len(words))][:10]
            size = rng.randint(10, 24)
            x = rng.randint(0, width - size * len(word))
            y = rng.randint(0, height - size)
            for j, char in enumerate(word):
                x1 = x + j * size
                rows.append(f"0 0 0 {x1 + size // 2} {y + size // 2} {x1} {y} "
                            f"{x1 + size - 2} {y + size} \"{char}\"")
            rows.append("")
        with open(os.path.join(gts, f"{100 + i}_GT.txt"), "w", encoding="utf8") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(train, "gt.txt"), "w", encoding="utf-8-sig") as f:
        for i in range(BORN_DIGITAL_TRAIN):
            place(fixture_path("interlaced.png"), os.path.join(train, f"word_{i + 1}.png"))
            f.write(f'word_{i + 1}.png, "{words[rng.randint(len(words))]}"\n')


@contextlib.contextmanager
def timed_calls(spans):
    """Wrap ``module.name`` (a module's function or an object's method) for
    each ``label: (module, name)`` of ``spans`` so that its calls add their
    host seconds to ``totals[label]``; yields ``totals``."""
    totals = dict.fromkeys(spans, 0.0)
    # What each object held itself (a method lives on its class: None).
    owned = {label: vars(module).get(name) for label, (module, name) in spans.items()}

    def wrap(label, fn):
        def call(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                totals[label] += time.perf_counter() - start
        return call

    for label, (module, name) in spans.items():
        setattr(module, name, wrap(label, getattr(module, name)))
    try:
        yield totals
    finally:
        for label, (module, name) in spans.items():
            if owned[label] is None:
                delattr(module, name)
            else:
                setattr(module, name, owned[label])


def fed_steps(trainer, batches, spans):
    """``trainer.fit`` over ``DATA_STEPS`` steps of ``batches``, under the
    profiler: (losses, host ms of each batch split by ``spans``, step ms by
    CUDA events, fit's wall ms, the device's busy ms in it)."""
    losses, host, step_ms, wall_ms = [], [], [], []

    def timed_batches():
        while True:
            with timed_calls(spans) as totals:
                start = time.perf_counter()
                batch = next(batches)
                total = time.perf_counter() - start
            host.append({"batch": total * 1e3, **{k: v * 1e3 for k, v in totals.items()}})
            yield batch

    train_step = trainer.train_step

    def timed_step(*args):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        losses.append(train_step(*args))
        end.record()
        torch.cuda.synchronize()
        step_ms.append(begin.elapsed_time(end))
        return losses[-1]

    def fit():
        start = time.perf_counter()
        trainer.fit(timed_batches(), steps_per_epoch=DATA_STEPS)
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - start) * 1e3)

    trainer.train_step = timed_step
    try:
        busy_ms = device_busy(fit)[0]
    finally:
        del trainer.train_step
    if len(losses) != DATA_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"data-fed train losses {losses}")
    return losses, host, step_ms, wall_ms[0], busy_ms


def fit_line(result, digits):
    """One line of a ``fed_steps`` result."""
    losses, host, step_ms, wall_ms, busy_ms = result
    return (f"losses {[round(l, digits) for l in losses]}; step ms "
            f"{[round(t, 3) for t in step_ms]}; host ms of a generator batch (median): "
            f"{host_split(host)}; fit {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
            f"(torch.profiler), idle {100 * (1 - busy_ms / wall_ms):.1f}%")


def host_split(host):
    """Median host ms of a batch and of each span, 'other' the rest."""
    med = {key: statistics.median(h[key] for h in host) for key in host[0]}
    med["other"] = med["batch"] - sum(v for k, v in med.items() if k != "batch")
    return ", ".join(f"{k} {v:.1f}" for k, v in med.items())


def data_phase(card, sweep_wrappers):
    """Phase 14: files on disk through the dataset loaders, ``tools.read``,
    the augmenters and both image generators into data-fed train steps on
    the card, with the network refused; then the trained detector's
    ``detect`` of the progressive fixture. Returns the sweep kernel's
    launches in that ``detect``."""
    from keras_ocr_tpu_torch import Detector, Recognizer, datasets, detection, tools
    from keras_ocr_tpu_torch.data import augmentation, wordlist
    from keras_ocr_tpu_torch.ops import cc, cc_cuda
    from keras_ocr_tpu_torch.ops.image import compute_input
    from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer

    device = torch.device("cuda")
    phase_start = time.perf_counter()
    decoded = {}
    for name, digest in DATA_FIXTURES.items():
        image = tools.read(fixture_path(name))
        got = hashlib.sha256(image.tobytes()).hexdigest()
        if got != digest:
            raise AssertionError(f"{name}: sha256 of the decode {got}, PIL's {digest}")
        decoded[name] = image.shape
    decode_ms = {name: median_seconds(lambda: tools.read(fixture_path(name)), runs=5)[0] * 1e3
                 for name in ("test_image.jpg", *DATA_FIXTURES)}
    print(f"data ({card}): tools.read of the committed fixtures equal to PIL's decode (sha256): "
          + ", ".join(f"{name} {shape}" for name, shape in decoded.items())
          + "; median decode ms of 5: " + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
          + f" (host CPU {host_cpu()})")

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    with offline(cache_dir=DATA_DIR) as urls:
        data_cache(DATA_DIR, wordlist.WORDS)
        icdar = datasets.get_icdar_2013_detector_dataset(cache_dir=DATA_DIR)
        born = datasets.get_born_digital_recognizer_dataset(cache_dir=DATA_DIR)
        if len(icdar) != ICDAR_2013_COUNT or len(born) != BORN_DIGITAL_TRAIN:
            raise AssertionError(f"loaders read {len(icdar)} / {len(born)} records")

        # The detector: ICDAR 2013 images, augmented, 640x640, batch 8.
        detector = Detector(weights=None, width=1.0, device=device, seed=14)
        augmenter = augmentation.Sequential([
            augmentation.Affine(rotate=(-10, 10), scale=(0.9, 1.1)),
            augmentation.GaussianBlur((0, 0.5)), augmentation.Multiply((0.9, 1.1))], seed=14)
        random.seed(14)
        np.random.seed(14)
        samples = datasets.get_detector_image_generator(icdar, width=640, height=640,
                                                        augmenter=augmenter)
        batches = detector.get_batch_generator(samples, batch_size=DATA_BATCH)
        craft = fed_steps(DetectorTrainer(detector), batches,
                          {"read": (tools, "read"), "augment": (tools, "augment"),
                           "compute_maps": (detection, "compute_maps")})
        print(f"data ({card}): get_icdar_2013_detector_dataset ({len(icdar)} images) -> "
              f"get_detector_image_generator (Affine, GaussianBlur, Multiply; 640x640) -> "
              f"Detector.get_batch_generator({DATA_BATCH}) -> DetectorTrainer.fit, "
              f"{DATA_STEPS} steps, full-width VGG CRAFT: {fit_line(craft, 6)}")

        # The recognizer: BornDigital crops, augmented, 31x200, batch 8.
        recognizer = Recognizer(weights=None, device=device, seed=14)
        augmenter = augmentation.Sequential([augmentation.GaussianBlur((0, 0.5)),
                                             augmentation.Multiply((0.8, 1.2))], seed=15)
        random.seed(15)
        np.random.seed(15)
        crops = datasets.get_recognizer_image_generator(
            born, height=31, width=200, alphabet=recognizer.alphabet, augmenter=augmenter)
        crnn = fed_steps(RecognizerTrainer(recognizer),
                         recognizer.get_batch_generator(crops, batch_size=DATA_BATCH),
                         {"read": (tools, "read"), "augment": (augmenter, "augment_image")})
        print(f"data ({card}): get_born_digital_recognizer_dataset ({len(born)} crops) -> "
              f"get_recognizer_image_generator (GaussianBlur, Multiply; 31x200) -> "
              f"Recognizer.get_batch_generator({DATA_BATCH}) -> RecognizerTrainer.fit, "
              f"{DATA_STEPS} steps, full-width CRNN: {fit_line(crnn, 4)}")
    if urls:
        raise AssertionError(f"phase 14 reached for the network: {urls}")

    # The trained detector reads the progressive fixture through the kernels,
    # at thresholds set by its heatmaps' quantiles (three steps from random
    # weights leave no text at the defaults). Every sweep-kernel call is held
    # exactly to its plain version on the same tensors, and the boxes to the
    # CPU run of the device path on the card's heatmaps (phase 8's bar).
    image = tools.read(fixture_path("progressive.jpg"))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # detect's forward = this one
    try:
        with torch.inference_mode():
            heatmaps = detector.model(compute_input(
                torch.from_numpy(image[None]).to(device))).cpu().numpy()
        quantiles, thresholds, components = quantile_thresholds(heatmaps)
        for wrapper in sweep_wrappers.values():
            wrapper.launches = 0
        record = []
        undo = checked_sweeps(cc, cc_cuda, record)
        try:
            boxes = detector.detect([image], **thresholds)
        finally:
            undo()
        launches = {name: wrapper.launches for name, wrapper in sweep_wrappers.items()}
    finally:
        torch.backends.cudnn.deterministic = saved
    if min(launches.values()) <= 0:
        raise AssertionError(f"data-trained detector's detect launched {launches}")
    cpu = Detector(weights=None, width=1.0, device="cpu", seed=14)
    cpu.model = FixedCraft(torch.from_numpy(heatmaps))
    got, want = boxes[0], cpu.detect([image], **thresholds)[0]
    err = float(np.abs(got - want).max()) if len(got) and got.shape == want.shape else 0.0
    if len(boxes) != 1 or not len(got) or got.shape != want.shape or not err <= REFINE_BAR:
        raise AssertionError(f"data-trained detect: {len(boxes)} results, boxes "
                             f"{got.shape} on the card, {want.shape} on the CPU, {err} px")
    print(f"data ({card}): Detector.detect of progressive.jpg by the data-trained detector at "
          f"its heatmaps' quantiles {quantiles} / {DETECT_QUANTILE} ("
          f"{', '.join(f'{k} {v:.5f}' for k, v in thresholds.items())}; {components} "
          f"components): {len(got)} boxes, within {err:.2e} px of the CPU run (bar "
          f"{REFINE_BAR}); launches {launches}, each of the {len(record)} calls equal to its "
          f"plain version; phase 14 took {time.perf_counter() - phase_start:.1f} s")
    return launches


# Phase 16: meshes. The CRAFT step's (batch, height, width), the timed
# steps per variant (after one warm-up), the scenes (two batches of 8, cut
# from 32 to keep the script's time) and the rounds of recognize_many in
# turns, and the step bars (the CPU tests'): loss relative, and each
# parameter or BatchNorm statistic within MESH_BAR * max(1, max|ref|).
MESH_CRAFT_STEP = (8, 640, 640)
MESH_STEP_RUNS = 5
MESH_IMAGES = 16
MESH_ROUNDS = 2  # 3 until phases 20-21 came
MESH_BAR = 1e-4


def mesh_pipelines(card, graph, plain, meshes, images, cc, cc_cuda, wrappers):
    """The full-width ``graph`` pipeline's models on each mesh against
    ``plain`` (the same models without a mesh): ``recognize_many`` of
    ``images`` at batch 8, the one-device mesh against ``plain`` at batch 8
    and the two-replica mesh against ``plain`` at batch 4 (the shard's
    size, so that every launch has the plain run's shapes): words equal,
    boxes within 1e-4; each replica's sweep-kernel calls equal to their
    plain versions; then images/s of the three in turns. Returns the
    mesh runs' launches."""
    from keras_ocr_tpu_torch import Pipeline

    def boxes_and_words(results):
        return ([[w for w, _ in image] for image in results],
                [np.array([b for _, b in image]).reshape(-1, 4, 2) for image in results])

    launches = {name: 0 for name in wrappers}
    sharded = {}
    for label, (mesh, batch) in meshes.items():
        pipe = Pipeline(plain.detector, plain.recognizer, 2, mesh=mesh, word_buckets=(64,))
        want_words, want_boxes = boxes_and_words(plain.recognize_many(images, batch_size=batch))
        for wrapper in wrappers.values():
            wrapper.launches = 0
        record = []
        undo = checked_sweeps(cc, cc_cuda, record)
        try:
            results = pipe.recognize_many(images, batch_size=8)
        finally:
            undo()
        check_results(results, len(images))
        counted = {name: wrapper.launches for name, wrapper in wrappers.items()}
        if min(counted.values()) <= 0:
            raise AssertionError(f"{graph} pipeline on the {label} mesh launched {counted}")
        words, boxes = boxes_and_words(results)
        err = max((float(np.abs(b - w).max()) for b, w in zip(boxes, want_boxes) if b.size),
                  default=0.0)
        if words != want_words or [b.shape for b in boxes] != [b.shape for b in want_boxes] \
                or not err <= 1e-4:
            raise AssertionError(f"{graph} pipeline on the {label} mesh: words equal "
                                 f"{words == want_words}, boxes within {err}")
        for name, count in counted.items():
            launches[name] += count
        sharded[label] = (pipe, err, counted, len(record), sum(map(len, words)))
    rates = {label: [] for label in ("no mesh", *meshes)}
    for _ in range(MESH_ROUNDS):
        for label, pipe in (("no mesh", plain), *((k, v[0]) for k, v in sharded.items())):
            start = time.perf_counter()
            check_results(pipe.recognize_many(images, batch_size=8), len(images))
            rates[label].append(len(images) / (time.perf_counter() - start))
    summary = "; ".join(
        f"{label}: words equal, boxes within {err:.1e}, launches {counted}, {calls} sweep "
        f"calls equal to their plain versions" for label, (_, err, counted, calls, _) in
        sharded.items())
    print(f"mesh ({card}): {graph} full width, {len(images)} images (640x480, scale 2, one "
          f"word bucket of 64): {summary}; recognize_many images/s at batch 8, median [range] "
          f"of {MESH_ROUNDS} in turns: " + ", ".join(
              f"{label} {statistics.median(v):.2f} [{min(v):.2f}-{max(v):.2f}]"
              for label, v in rates.items()))
    return launches


def mesh_steps(card, what, make, trainer_cls, bridge, batch, meshes):
    """One train step of ``make()``'s model without a mesh and on each mesh
    from one state, in float64: losses within MESH_BAR relative, every
    parameter and BatchNorm statistic within MESH_BAR * max(1, max|ref|) of
    the one-device step's; then each variant's float32 step ms (CUDA
    events, median of MESH_STEP_RUNS after a warm-up)."""
    facade = make()
    state = {k: v.clone() for k, v in facade.model.state_dict().items()}

    def fresh(dtype):
        facade.model.to(dtype).load_state_dict(state)
        return facade

    variants = {"no mesh": None, **meshes}
    steps = {}
    for label, mesh in variants.items():
        trainer = trainer_cls(fresh(torch.float64), mesh=mesh)
        loss = trainer.train_step(batch)
        steps[label] = loss, dict(tree_leaves(bridge(trainer.model)))
    ref_loss, ref = steps["no mesh"]
    errors = {}
    for label in meshes:
        loss, leaves = steps[label]
        worst = max(float(np.abs(leaves[k] - v).max()) / max(1.0, float(np.abs(v).max()))
                    for k, v in ref.items())
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        if not (loss_err <= MESH_BAR and worst <= MESH_BAR):
            raise AssertionError(f"{what} step on the {label} mesh: loss {loss_err:.3e} "
                                 f"relative, worst leaf {worst:.3e}")
        errors[label] = loss_err, worst
    step_ms = {}
    for label, mesh in variants.items():
        trainer = trainer_cls(fresh(torch.float32), mesh=mesh)
        step_ms[label] = cuda_median_ms(lambda: trainer.train_step(batch), runs=MESH_STEP_RUNS)
    print(f"mesh ({card}): {what} step from one state in float64, each mesh against no mesh: "
          + "; ".join(f"{label} loss within {e[0]:.2e} relative, parameters and statistics "
                      f"within {e[1]:.2e} (bar {MESH_BAR})" for label, e in errors.items())
          + "; float32 step ms (median of " + f"{MESH_STEP_RUNS}): "
          + ", ".join(f"{label} {ms:.3f}" for label, ms in step_ms.items()))


def mesh_phase(card, pipelines, scenes, all_wrappers):
    """Phase 16: the native host-ops library, the full-width pipelines on a
    one-device mesh and on two replicas of the one card, and the CRNN and
    CRAFT train steps on both meshes. Returns the kernels' launches in the
    mesh pipelines' runs."""
    from keras_ocr_tpu_torch import Detector, Recognizer, detection, native, parallel, weights
    from keras_ocr_tpu_torch.models.crnn import DEFAULT_BUILD_PARAMS
    from keras_ocr_tpu_torch.ops import cc, cc_cuda
    from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer

    phase_start = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host-ops library did not build (see the warning)")
    heatmaps = refine_heatmaps(seed=16)[:2]
    calls = native.calls
    start = time.perf_counter()
    with_library = detection.getBoxes(heatmaps)
    library_s = time.perf_counter() - start
    library_calls = native.calls - calls
    available = native.available
    native.available = lambda: False
    try:
        start = time.perf_counter()
        without = detection.getBoxes(heatmaps)
        plain_s = time.perf_counter() - start
    finally:
        native.available = available
    if library_calls <= 0 or any(a.shape != b.shape or not np.array_equal(a, b)
                                 for a, b in zip(with_library, without)):
        raise AssertionError(f"host oracle: {library_calls} library calls, boxes equal "
                             f"without it: {[np.array_equal(a, b) for a, b in zip(with_library, without)]}")
    print(f"mesh: native host-ops library built ({native.library_path()}); the host oracle "
          f"getBoxes on 2 refine-phase heatmaps (480x640): {sum(map(len, with_library))} "
          f"boxes, identical with the library ({library_calls} calls, {library_s:.3f} s) and "
          f"without it ({plain_s:.3f} s)")

    device = torch.device("cuda", torch.cuda.current_device())
    meshes = {"one-device": (parallel.create_mesh(), 8),
              "two-replica": (parallel.create_mesh(devices=[device, device]), 4)}
    images = (scenes * 3)[:MESH_IMAGES]
    launches = {name: 0 for name in all_wrappers}
    for graph, plain in pipelines.items():
        wrappers = {name: w for name, w in all_wrappers.items()
                    if graph == "folded" or name.startswith("cc_")}
        reference = type(plain)(plain.detector, plain.recognizer, 2, word_buckets=(64,))
        for name, count in mesh_pipelines(card, graph, reference, meshes, images, cc, cc_cuda,
                                          wrappers).items():
            launches[name] += count

    steps = {label: mesh for label, (mesh, _) in meshes.items()}
    rng = np.random.RandomState(16)
    no_dropout = dict(DEFAULT_BUILD_PARAMS, dropout=0.0)
    mesh_steps(card, "CRNN (full width, dropout 0) batch 8",
               lambda: Recognizer(weights=None, build_params=no_dropout, device=device, seed=16),
               RecognizerTrainer, weights.crnn_variables, crnn_batch(rng, 8, 48, 36), steps)
    mesh_steps(card, f"CRAFT (width 1.0) {'x'.join(map(str, MESH_CRAFT_STEP))}",
               lambda: Detector(weights=None, width=1.0, device=device, seed=17),
               DetectorTrainer, weights.craft_variables, craft_batch(rng, *MESH_CRAFT_STEP),
               steps)
    print(f"mesh ({card}): phase 16 took {time.perf_counter() - phase_start:.1f} s")
    return launches


# Phase 18: spatial sharding. The meshes, all on the one card: one data
# position's strips on 2 and on 4 model devices, and a hybrid mesh of 2
# positions (slice 2, data 1) of 2 strips each; the scenes of each
# recognize_many and its timed rounds in turns; the CRAFT forwards' runs
# (CUDA events); the heatmaps'
# bars against the whole forward (PARITY.md's float32 bar, PERF.md §2's
# bf16 bars: max over max(1, max|ref|), mean).
SPATIAL_MESHES = {
    "1x2": lambda parallel, device: parallel.create_mesh((1, 2), devices=[device] * 2),
    "1x4": lambda parallel, device: parallel.create_mesh((1, 4), devices=[device] * 4),
    "hybrid 2x1x2": lambda parallel, device: parallel.create_hybrid_mesh(
        2, (1, 2), devices=[device] * 4),
}
SPATIAL_IMAGES = 8
# Cut from 3 rounds and 10 runs to keep the script's time with phases 20-21.
SPATIAL_ROUNDS = 2
SPATIAL_FORWARD_RUNS = 5
SPATIAL_BAR = 1e-4
SPATIAL_BF16_BARS = (8e-3, 1e-3)
# detect's thresholds for the EfficientNet graphs' checks, whose random
# sigmoid heatmaps sit near 0.5: every pixel text and no link, one box an
# image, so that heatmaps within the bars give the same boxes. Their timed
# rounds take the defaults, as every graph's do (a whole-image box climbs
# the warp ladder, and random heatmaps at quantile thresholds give dozens
# of blobs an image: either way the host's post-processing would take the
# time).
SPATIAL_B0_KWARGS = {"detection_threshold": -10.0, "text_threshold": -10.0,
                     "link_threshold": 10.0, "size_threshold": 1}


def words_and_boxes(results):
    return ([[w for w, _ in image] for image in results],
            [np.array([b for _, b in image]).reshape(-1, 4, 2) for image in results])


def spatial_phase(card, detector, folded, recognizer, scenes, wrappers):
    """Phase 18: the full-width pipelines on meshes whose ``model`` axis
    cuts CRAFT's input into row strips, against the same models without a
    mesh. Returns the kernels' launches on the strip path (the bf16 mode's
    as ``*_bf16``)."""
    from keras_ocr_tpu_torch import Detector, Pipeline, parallel
    from keras_ocr_tpu_torch.models import craft as craft_module
    from keras_ocr_tpu_torch.ops import cc, cc_cuda, conv_cuda

    phase_start = time.perf_counter()
    device = recognizer.device
    folded_bf16 = Detector(weights=None, width=1.0, fold_bn=True, compute_dtype=torch.bfloat16,
                           device=device)
    folded_bf16.model.load_state_dict(folded.model.state_dict())
    # The seconds of the EfficientNet graphs' part of the phase.
    efficientnet_s = time.perf_counter()
    b0, warned = efficientnet_detector("efficientnetb0", device)
    if warned:
        seed_batch_norm(b0.model, seed=2)
    b0_bf16, _ = efficientnet_detector("efficientnetb0", device, compute_dtype=torch.bfloat16)
    b0_bf16.model.load_state_dict(b0.model.state_dict())
    efficientnet_s = time.perf_counter() - efficientnet_s
    graphs = {"standard": (detector, {}), "folded": (folded, {}),
              "folded bf16": (folded_bf16, {}), "B0": (b0, SPATIAL_B0_KWARGS),
              "B0 bf16": (b0_bf16, SPATIAL_B0_KWARGS)}
    meshes = {label: make(parallel, device) for label, make in SPATIAL_MESHES.items()}
    images = scenes[:SPATIAL_IMAGES]
    launches = {}
    checks_s = rates_s = forwards_s = 0.0
    for graph, (owner, kwargs) in graphs.items():
        graph_start = start = time.perf_counter()
        bf16 = owner.model.dtype == torch.bfloat16
        plain = Pipeline(owner, recognizer, 2, word_buckets=(64,))
        want_words, want_boxes = words_and_boxes(plain.recognize_many(
            images, batch_size=8, detection_kwargs=kwargs))
        with torch.inference_mode():
            x = craft_input(plain, scenes[:2])
            ref = owner.model(x)
        scale = max(1.0, float(ref.abs().max()))
        pipes, lines = {"no mesh": plain}, []
        for label, mesh in meshes.items():
            pipe = pipes[label] = Pipeline(owner, recognizer, 2, mesh=mesh, word_buckets=(64,))
            if any(strips is None for strips in pipe._strips):
                raise AssertionError(f"{graph} on the {label} mesh runs no strips")
            with torch.inference_mode():
                heatmaps = pipe._craft(0, owner.model)(x)
            diff = (heatmaps - ref).abs()
            err, mean = float(diff.max()), float(diff.mean())
            bar, mean_bar = SPATIAL_BF16_BARS if bf16 else (SPATIAL_BAR, None)
            if heatmaps.shape != ref.shape or not (err <= bar * scale) or (
                    mean_bar is not None and not mean <= mean_bar):
                raise AssertionError(f"{graph} strips on the {label} mesh: heatmaps "
                                     f"{tuple(heatmaps.shape)}, max {err} (bar {bar * scale}), "
                                     f"mean {mean}")
            # The strip path once more with every kernel call held to its
            # plain version, its launches counted from zero.
            for wrapper in wrappers.values():
                wrapper.launches = 0
            sweep_calls, conv_calls = [], []
            undo = checked_sweeps(cc, cc_cuda, sweep_calls)
            craft_module.conv_cuda = CheckedConvs(conv_cuda, conv_calls, f"{graph} strip chain")
            try:
                results = pipe.recognize_many(images, batch_size=8, detection_kwargs=kwargs)
            finally:
                craft_module.conv_cuda = conv_cuda
                undo()
            check_results(results, len(images))
            counted = {name: wrapper.launches for name, wrapper in wrappers.items()
                       if owner.fold_bn or name.startswith("cc_")}
            if min(counted.values()) <= 0:
                raise AssertionError(f"{graph} on the {label} mesh launched {counted}")
            words, boxes = words_and_boxes(results)
            box_err = max((float(np.abs(b - w).max()) for b, w in zip(boxes, want_boxes)
                           if b.size), default=0.0)
            if words != want_words or [b.shape for b in boxes] != [b.shape for b in want_boxes] \
                    or not box_err <= 1e-4:
                raise AssertionError(f"{graph} pipeline on the {label} mesh: words equal "
                                     f"{words == want_words}, boxes within {box_err}")
            for name, count in counted.items():
                key = f"{name}_bf16" if bf16 and name.startswith("conv") else name
                launches[key] = launches.get(key, 0) + count
            lines.append(f"{label}: heatmaps max {err:.3e} mean {mean:.3e} from the whole "
                         f"forward, words equal, boxes within {box_err:.1e}, launches "
                         f"{counted}, {len(conv_calls)} conv_chain and {len(sweep_calls)} sweep "
                         "calls held to their plain versions")
        checks_s += time.perf_counter() - start
        # recognize_many images/s, the variants in turns (after the runs
        # above warmed them), and the first round's peak memory above the
        # resident models.
        start = time.perf_counter()
        rates, peaks = {label: [] for label in pipes}, {}
        for _ in range(SPATIAL_ROUNDS):
            for label, pipe in pipes.items():
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                begin = time.perf_counter()
                check_results(pipe.recognize_many(images, batch_size=8), len(images))
                rates[label].append(len(images) / (time.perf_counter() - begin))
                peaks.setdefault(label, (torch.cuda.max_memory_allocated() - resident) / 1e9)
        rates_s += time.perf_counter() - start
        start = time.perf_counter()
        # CRAFT forwards at 960x1280, batch 1 and 8: no strips, 2 and 4;
        # the folded graphs (the conv kernel on strips) and the float32 B0
        # (cuDNN's depthwise convs and the squeeze-excite meetings), to
        # keep the script's time.
        forward_ms = {}
        with torch.inference_mode():
            for batch in ((1, 8) if graph in ("folded", "folded bf16", "B0") else ()):
                x = torch.randn((batch, 960, 1280, 3), device=device,
                                generator=torch.Generator(device=device).manual_seed(batch))
                for label in ("no mesh", "1x2", "1x4"):
                    fn = owner.model if label == "no mesh" else pipes[label]._craft(0, owner.model)
                    forward_ms[label, batch] = cuda_median_ms(lambda: fn(x),
                                                              runs=SPATIAL_FORWARD_RUNS)
                del x
        meetings = {label: strip_meetings(pipes[label]) for label in ("1x2", "1x4")}
        forwards_s += time.perf_counter() - start
        print(f"spatial ({card}): {graph} full width, {len(images)} scenes (640x480, scale 2, "
              f"one word bucket of 64) against no mesh: " + "; ".join(lines)
              + f"; recognize_many images/s at batch 8 (default thresholds), median [range] of "
              f"{SPATIAL_ROUNDS} in turns, and peak GB above the models: " + ", ".join(
                  f"{label} {statistics.median(v):.2f} [{min(v):.2f}-{max(v):.2f}] "
                  f"({peaks[label]:.3f} GB)" for label, v in rates.items())
              + ("" if not forward_ms else
                 f"; CRAFT forward at 960x1280 (median of {SPATIAL_FORWARD_RUNS}) batch 1 / 8: "
                 + ", ".join(f"{label} {forward_ms[label, 1]:.3f} / "
                             f"{forward_ms[label, 8]:.3f} ms"
                             for label in ("no mesh", "1x2", "1x4"))
                 + f" (meetings a strip forward: 1x2 {meetings['1x2']}, 1x4 "
                 f"{meetings['1x4']})"))
        del pipes, plain
        gc.collect()
        torch.cuda.empty_cache()
        if owner.backbone_name != "vgg":
            efficientnet_s += time.perf_counter() - graph_start
    del graphs, b0, b0_bf16, folded_bf16
    start = time.perf_counter()
    b7_line = b7_strips(card, recognizer, scenes, meshes["1x2"])
    checks_s += time.perf_counter() - start
    efficientnet_s += time.perf_counter() - start
    print(b7_line)
    print(f"spatial ({card}): launches on the strip path {launches}; phase 18 took "
          f"{time.perf_counter() - phase_start:.1f} s (checks {checks_s:.1f}, rates "
          f"{rates_s:.1f}, forwards {forwards_s:.1f}; the EfficientNet B0 and B7 part "
          f"{efficientnet_s:.1f})")
    return launches


def strip_meetings(pipe) -> int:
    """The meetings of each strip in the last strip forward of ``pipe``'s
    first data position."""
    strips = pipe._strips[0]
    return strips._groups[len(strips.devices)]._count[0]


def b7_strips(card, recognizer, scenes, mesh):
    """Phase 18's EfficientNet-B7 check: its heatmaps of one scene
    (960x1280) on the strips of ``mesh`` against the whole forward, at
    the float32 bar. Returns the line to print."""
    from keras_ocr_tpu_torch import Pipeline

    b7, warned = efficientnet_detector("efficientnetb7", recognizer.device, seed=18)
    if warned:
        seed_batch_norm(b7.model, seed=18)
    pipe = Pipeline(b7, recognizer, 2, mesh=mesh, word_buckets=(64,))
    with torch.inference_mode():
        x = craft_input(pipe, scenes[:1])
        ref = b7.model(x)
        heatmaps = pipe._craft(0, b7.model)(x)
    scale = max(1.0, float(ref.abs().max()))
    err = float((heatmaps - ref).abs().max())
    if heatmaps.shape != ref.shape or not err <= SPATIAL_BAR * scale:
        raise AssertionError(f"B7 strips: heatmaps {tuple(heatmaps.shape)}, max {err} "
                             f"(bar {SPATIAL_BAR * scale})")
    return (f"spatial ({card}): B7 heatmaps of 1 scene (960x1280) on 2 strips within {err:.3e} "
            f"of the whole forward (bar {SPATIAL_BAR} x max(1, max|ref| {scale:.3f})), "
            f"{strip_meetings(pipe)} meetings a strip")


# Phase 15: bfloat16. The bf16 mode's bound: the H100 SXM's dense bf16
# tensor-core rate, TFLOP/s; its bars against the plain bf16 version: one
# bf16 ulp for a single layer, and for a chain BF16_CHAIN_BAR * max(1,
# max|plain|) with BF16_ULP_SHARE of the values within one ulp.
BF16_TFLOPS = 989
BF16_CHAIN_BAR = 1.6e-2
BF16_ULP_SHARE = 0.99
# The JAX package's graft entry configuration (__graft_entry__.py:21-45).
ENTRY_SHAPE = (1, 256, 256, 3)
ENTRY_MAX_COMPONENTS = 64
ENTRY_MAX_WORDS = 32


def bf16_bytes(batch, height, width, cin, plan, pool=False, tap=False):
    """Bytes a bf16-mode chain must move: its bf16 activations in and out
    (pooled a quarter, and the tap as well) and the float32 weights and
    biases it is given."""
    total = 0
    for i, (k, cout, _) in enumerate(plan):
        out = batch * height * width * cout
        if pool and i == len(plan) - 1:
            out = out // 4 + (out if tap else 0)
        total += 2 * (batch * height * width * cin + out) + 4 * (k * k * cin * cout + cout)
        cin = cout
    return total


def bf16_tiles(conv_cuda, height, width, plan):
    """The Cout tile of each bf16 layer of a batch-1 chain."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return [conv_cuda.tile_n(cout, conv_cuda.tiles_m(1, height, width), torch.bfloat16, sms)
            for _, cout, _ in plan]


def bf16_bound_ms(flop, nbytes):
    """The larger of the operations at the dense bf16 rate and the bytes at
    the HBM rate."""
    return max(flop / (BF16_TFLOPS * 1e9), nbytes / (HBM_TBS * 1e9))


def check_bf16(conv_cuda, what, out, ref, layers):
    """The bf16 mode's bars; returns (max |diff|, share within one ulp)."""
    if out.dtype != torch.bfloat16 or out.shape != ref.shape:
        raise AssertionError(f"{what}: {out.dtype} {tuple(out.shape)} vs {tuple(ref.shape)}")
    ulps = conv_cuda.bf16_ulps(out, ref)
    err = float((out.float() - ref.float()).abs().max())
    share = float((ulps <= 1.0).float().mean())
    if layers == 1 and float(ulps.max()) > 1.0:
        raise AssertionError(f"{what}: {float(ulps.max())} ulps from the plain version")
    bar = BF16_CHAIN_BAR * max(1.0, float(ref.float().abs().max()))
    if layers > 1 and not (err <= bar and share >= BF16_ULP_SHARE):
        raise AssertionError(f"{what}: max |diff| {err} (bar {bar}), {share} within one ulp")
    return err, share


def conv_device_ms(fn, calls=5):
    """(conv kernel ms, other kernels ms, conv kernel launches) per call of
    ``fn``, from ``torch.profiler`` over ``calls`` calls after a warm-up:
    the device time of the ``conv_tc`` kernels apart from the call's other
    kernels (copies, casts, the im2col) and its host gaps. A torch kernel
    opens and closes the window (the conv kernels come from a library of
    their own)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        for _ in range(calls):
            fn()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    conv = other = 0.0
    launches = 0
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = event.self_device_time_total / 1e3 / calls
        if "conv_tc" in event.key:
            conv += ms
            launches += event.count
        else:
            other += ms
    return conv, other, launches / calls


def graph_replay_ms(fn):
    """Device time of one call of ``fn`` replayed from a CUDA graph: its
    kernels back to back with no host in between (median of 20 by CUDA
    events); None where the call cannot be captured."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as error:
        print(f"graph capture failed: {error}", flush=True)
        return None
    return cuda_median_ms(graph.replay)


def device_line(device_ms, seen, launches, replay_ms):
    """The device-time part of a phase 15 line: the profiler's conv kernel
    time where it saw every launch, and the CUDA-graph replay either way."""
    profiler = (f"conv kernel {device_ms:.4f} ms of device time (torch.profiler)"
                if seen == launches else
                f"the profiler saw {seen:g} of {launches} conv launches a call")
    replay = "not captured" if replay_ms is None else f"{replay_ms:.4f} ms"
    return f"{profiler}, CUDA-graph replay of the call {replay}"


def bf16_kernels(card, conv_cuda, fp32_ms):
    """(1) The conv kernel's bf16 mode against its plain version at the
    CRAFT shapes, each chain's and C3's layer's call time (CUDA events)
    beside its kernel's device time (``torch.profiler``); returns its two
    kernel-line entries."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    chain = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_by": "operations",
             "library_ms": None}
    single = {"max_abs_err": 0.0, "bound_by": "operations"}
    total_flop = total_bytes = 0
    totals = {"device": 0.0, "replay": 0.0}
    for name, height, width, cin, plan, pool, tap in CRAFT_CHAINS:
        x, convs = seeded_chain(gen, 1, height, width, cin, plan)
        x = x.to(torch.bfloat16)

        def kernel():
            return conv_cuda.conv_chain(x, convs, pool=pool, tap_prepool=tap)

        def plain():
            return conv_cuda.conv_chain_plain(x, convs, pool=pool, tap_prepool=tap)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(out, ref, ("output", "tap"))) if tap else [(out, ref, "output")]
        checks = [check_bf16(conv_cuda, f"bf16 conv_chain {name} {what}", o, r, len(plan))
                  for o, r, what in pairs]
        err, share = max(c[0] for c in checks), min(c[1] for c in checks)
        chain["max_abs_err"] = max(chain["max_abs_err"], err)
        ms, plain_ms = cuda_median_ms(kernel), cuda_median_ms(plain)
        device_ms, other_ms, seen = conv_device_ms(kernel)
        replay_ms = graph_replay_ms(kernel)
        chain["ms"] += ms
        chain["plain_ms"] += plain_ms
        totals["device"] += device_ms if seen == len(plan) else math.nan
        totals["replay"] += math.nan if replay_ms is None else replay_ms
        flop = conv_flop(1, height, width, cin, plan)
        total_flop += flop
        total_bytes += bf16_bytes(1, height, width, cin, plan, pool, tap)
        tflops = flop / ms / 1e9
        print(f"bfloat16 kernel vs plain ({card}): conv_chain {name}: max |diff| {err:.3e}, "
              f"{100 * share:.3f}% within one ulp; call {ms:.4f} ms ({tflops:.2f} TFLOP/s, "
              f"{100 * tflops / BF16_TFLOPS:.1f}% of {BF16_TFLOPS} TFLOP/s; float32 mode "
              f"{fp32_ms[name]:.4f} ms), {device_line(device_ms, seen, len(plan), replay_ms)} "
              f"(other kernels {other_ms:.4f} ms; Cout tiles "
              f"{bf16_tiles(conv_cuda, height, width, plan)}), plain {plain_ms:.4f} ms "
              f"(median of 20)")
    chain["bound_ms"] = bf16_bound_ms(total_flop, total_bytes)
    print(f"bfloat16 kernel vs plain ({card}): conv_chain, the 12 chains at 960x1280: "
          f"{total_flop / 1e9:.2f} GFLOP, {total_bytes / 1e9:.3f} GB, kernel {chain['ms']:.4f} ms "
          f"({total_flop / chain['ms'] / 1e9:.2f} TFLOP/s, "
          f"{100 * total_flop / chain['ms'] / 1e9 / BF16_TFLOPS:.1f}% of {BF16_TFLOPS}; bound "
          f"{chain['bound_ms']:.4f} ms, {100 * chain['bound_ms'] / chain['ms']:.1f}% of it), "
          f"conv kernels {totals['device']:.4f} ms of device time (torch.profiler; nan where "
          f"it missed a launch), the calls replayed from CUDA graphs {totals['replay']:.4f} ms "
          f"({100 * total_flop / totals['replay'] / 1e9 / BF16_TFLOPS:.1f}%), "
          f"float32 mode {sum(fp32_ms[c[0]] for c in CRAFT_CHAINS):.4f} ms, plain "
          f"{chain['plain_ms']:.4f} ms")
    for batch, height, width, cin, cout in CONV3X3_SHAPES:
        x, ((w, b, _),) = seeded_chain(gen, batch, height, width, cin, ((3, cout, True),))
        x = x.to(torch.bfloat16)
        for relu in (True, False):
            out = conv_cuda.conv3x3_bias_act(x, w, b, relu=relu)
            ref = conv_cuda.conv3x3_bias_act_plain(x, w, b, relu=relu)
            torch.cuda.synchronize()
            err, _ = check_bf16(conv_cuda, f"bf16 conv3x3_bias_act {(batch, height, width, cin)}",
                                out, ref, 1)
            single["max_abs_err"] = max(single["max_abs_err"], err)
        ms = cuda_median_ms(lambda: conv_cuda.conv3x3_bias_act(x, w, b))
        device_ms, _, seen = conv_device_ms(lambda: conv_cuda.conv3x3_bias_act(x, w, b))
        replay_ms = graph_replay_ms(lambda: conv_cuda.conv3x3_bias_act(x, w, b))
        plain_ms = cuda_median_ms(lambda: conv_cuda.conv3x3_bias_act_plain(x, w, b))
        # The library call: one cuDNN bf16 convolution with its bias, NCHW.
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
        b16 = b.to(torch.bfloat16)
        library_ms = cuda_median_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, b16,
                                                                       padding=1))
        library_replay_ms = graph_replay_ms(
            lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, b16, padding=1))
        flop = conv_flop(batch, height, width, cin, ((3, cout, True),))
        bound_ms = bf16_bound_ms(flop, bf16_bytes(batch, height, width, cin, ((3, cout, True),)))
        if "ms" not in single:
            single.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms)
        print(f"bfloat16 kernel vs plain ({card}): conv3x3_bias_act {(batch, height, width, cin)} "
              f"-> {cout}: max |diff| {err:.3e} (within one ulp); call {ms:.4f} ms "
              f"({flop / ms / 1e9:.2f} TFLOP/s; bound {bound_ms:.4f} ms, "
              f"{100 * bound_ms / ms:.1f}% of it), {device_line(device_ms, seen, 1, replay_ms)}, "
              f"plain {plain_ms:.4f} ms, F.conv2d bf16 with bias {library_ms:.4f} ms (CUDA-graph "
              f"replay {library_replay_ms} ms): the call {library_ms / ms:.2f}x cuDNN's speed "
              f"(median of 20)")
    return {"conv_chain_bf16": chain, "conv3x3_bias_act_bf16": single}


def bf16_phase(card, conv_cuda, fp32, scenes, pass_fraction, wrappers, report):
    """Phase 15: the bfloat16 path. ``fp32`` holds this run's float32
    numbers and models, ``report`` the kernel-line entries of the bf16 mode
    (:func:`bf16_kernels`, run right after phase 3, before any other
    profiler session). Returns those entries and their launches on the bf16
    main path."""
    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer
    from keras_ocr_tpu_torch.models.craft import fold_bn_state_dict
    from keras_ocr_tpu_torch.utils import golden

    phase_start = time.perf_counter()
    device = torch.device("cuda")
    bf16 = torch.bfloat16

    # (2) The golden artifact in bfloat16, standard and folded; the words
    # that differ from the float32 run. (Its export: the card test
    # test_bf16_golden_on_card_live_and_exported.)
    for fold_bn in (False, True):
        label = "golden, bfloat16" + (", folded" if fold_bn else "")
        pipe = golden.load_golden_pipeline(ARTIFACT, bf16, device=device, fold_bn=fold_bn)[0]
        for wrapper in wrappers.values():
            wrapper.launches = 0
        result = golden.run_golden_check(ARTIFACT, pipeline=pipe)
        live = {name: wrapper.launches for name, wrapper in wrappers.items()}
        if not result["pass"]:
            raise AssertionError(f"{label} check failed: {result}")
        if fold_bn and min(live["conv_chain"], live["conv3x3_bias_act"]) <= 0:
            raise AssertionError(f"{label}: the conv kernel was not launched: {live}")
        differ = [(a["image"], b["predicted"], a["predicted"]) for a, b in zip(
            result["per_scene"], fp32["golden"][fold_bn]["per_scene"])
            if a["predicted"] != b["predicted"]]
        print(f"{label} ({card}): fraction {result['fraction']} over {result['n_words']} words "
              f"/ {result['n_scenes']} scenes (pass >= {pass_fraction}); launches {live}; "
              f"scenes whose words differ from the float32 run (float32, bfloat16): "
              f"{differ or 'none'}")
        del pipe

    # (3) Full width in bfloat16, standard and folded, on the float32 run's
    # weights (seeded BatchNorm statistics).
    state = fp32["detector"].model.state_dict()
    detector = Detector(weights=None, width=1.0, compute_dtype=bf16, device=device)
    detector.model.load_state_dict(state)
    folded = Detector(weights=None, width=1.0, fold_bn=True, compute_dtype=bf16, device=device)
    folded.model.load_state_dict(fold_bn_state_dict(state))
    recognizer = Recognizer(weights=None, compute_dtype=bf16, device=device, seed=1)
    pipelines = {"standard": Pipeline(detector=detector, recognizer=recognizer, scale=2),
                 "folded": Pipeline(detector=folded, recognizer=recognizer, scale=2)}
    with torch.inference_mode():
        x = craft_input(pipelines["standard"], scenes[:2])
        ref = fp32["detector"].model(x)
        for label, model in (("standard", detector.model), ("folded", folded.model)):
            heatmaps = model(x)
            if heatmaps.dtype != torch.float32 or not torch.isfinite(heatmaps).all():
                raise AssertionError(f"bf16 {label} heatmaps: {heatmaps.dtype}, not finite")
            print(f"full width, bfloat16 ({card}): {label} heatmaps of 2 scenes (960x1280) "
                  f"{float((heatmaps - ref).abs().max()):.3e} max, "
                  f"{float((heatmaps - ref).abs().mean()):.3e} mean from the float32 "
                  f"unfolded graph (max|ref| {float(ref.abs().max()):.3e})")
    for wrapper in wrappers.values():
        wrapper.launches = 0
    times = {}
    for label, pipe in pipelines.items():
        check_results(pipe.recognize([scenes[0]]), 1)
        enqueue_without_sync(pipe, scenes[:8])
        times[label] = time_pipeline(pipe, scenes)
    launches = {f"{name}_bf16": wrappers[name].launches
                for name in ("conv_chain", "conv3x3_bias_act")}
    # Peak memory above what is resident (every model of the run stays
    # allocated), for one recognize_many of 32 images at batch 8 of each
    # pipeline, float32's included.
    peaks = {}
    for label, pipe in (*((f"bfloat16 {k}", p) for k, p in pipelines.items()),
                        *((f"float32 {k}", p) for k, p in fp32["pipelines"].items())):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        check_results(pipe.recognize_many((scenes * 3)[:32], batch_size=8), 32)
        torch.cuda.synchronize()
        peaks[label] = (torch.cuda.max_memory_allocated() - resident) / 1e9
    print(f"full width, bfloat16 ({card}): device programs of 8 images enqueued with no host "
          f"synchronisation; recognize p50 {times['standard'][0]:.2f} ms standard, "
          f"{times['folded'][0]:.2f} ms folded (float32 {fp32['times']['unfolded'][0]:.2f} / "
          f"{fp32['times']['folded'][0]:.2f} ms); recognize_many {times['standard'][1]:.2f} / "
          f"{times['folded'][1]:.2f} images/s (float32 {fp32['times']['unfolded'][1]:.2f} / "
          f"{fp32['times']['folded'][1]:.2f}); peak memory above the resident models in one "
          f"recognize_many of 32 images at batch 8: " + ", ".join(
              f"{label} {gb:.3f} GB" for label, gb in peaks.items())
          + f"; conv kernel launches in bf16 {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the bf16 path skipped a conv kernel: {launches}")

    # (4) CRAFT forwards in bfloat16 at 960x1280, batch 1 and 8.
    b0 = efficientnet_detector("efficientnetb0", device, compute_dtype=bf16)[0]
    models = {"vgg": detector.model, "vgg folded": folded.model, "efficientnetb0": b0.model}
    forward_ms = {}
    with torch.inference_mode():
        for batch_size, runs in ((1, 10), (8, 5)):
            x = torch.randn((batch_size, 960, 1280, 3), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(batch_size))
            for name, model in models.items():
                forward_ms[name, batch_size] = cuda_median_ms(lambda: model(x), runs=runs)
            del x
    print(f"CRAFT forward, bfloat16 ({card}), 960x1280 (median of 10 / 5): " + "; ".join(
        f"{name} batch 1 {forward_ms[name, 1]:.3f} ms, batch 8 {forward_ms[name, 8]:.3f} ms "
        f"({forward_ms[name, 8] / 8 / forward_ms[name, 1]:.2f} of batch 1's per image)"
        for name in models) + f"; float32 VGG {fp32['forward_ms']['unfolded', 1]:.3f} / "
        f"{fp32['forward_ms']['unfolded', 8]:.3f} ms, folded "
        f"{fp32['forward_ms']['folded', 1]:.3f} / {fp32['forward_ms']['folded', 8]:.3f} ms")
    slow = [name for name in models
            if forward_ms[name, 8] / 8 > BATCH_SWEEP_BAR * forward_ms[name, 1]]
    if slow:
        raise AssertionError(f"bf16 CRAFT forwards {slow} exceed {BATCH_SWEEP_BAR}x batch 1's "
                             "time per image at batch 8")
    del pipelines, detector, folded, b0, models

    # (5) The graft entry's configuration (__graft_entry__.py) through the
    # port's Pipeline.
    import string

    entry_detector = Detector(weights=None, max_components=ENTRY_MAX_COMPONENTS,
                              compute_dtype=bf16, device=device)
    entry_recognizer = Recognizer(weights=None, alphabet=string.digits + string.ascii_lowercase,
                                  compute_dtype=bf16, device=device)
    entry = Pipeline(detector=entry_detector, recognizer=entry_recognizer, scale=2,
                     max_words=ENTRY_MAX_WORDS)
    images = np.random.RandomState(0).uniform(0, 255, ENTRY_SHAPE).astype(np.float32)
    with torch.inference_mode():
        packed = entry._device_pipeline(torch.from_numpy(images).to(device), 0.7, 0.4, 0.4,
                                        10.0, ENTRY_MAX_COMPONENTS, ENTRY_MAX_WORDS)
    torch.cuda.synchronize()
    build = entry_recognizer.build_params
    frames = build["width"] // build["pool_size"] ** 2 - build["rnn_steps_to_discard"]
    want = (1, ENTRY_MAX_WORDS, 8 + 1 + frames + 2)
    if tuple(packed.shape) != want or packed.dtype != torch.float32 or not bool(
            torch.isfinite(packed).all()):
        raise AssertionError(f"entry configuration: packed {packed.dtype} "
                             f"{tuple(packed.shape)}, want {want}, finite")
    results = entry.recognize([images[0].astype(np.uint8)])
    check_results(results, 1)
    print(f"entry configuration, bfloat16 ({card}): {ENTRY_SHAPE} float32 images, "
          f"max_components {ENTRY_MAX_COMPONENTS}, max_words {ENTRY_MAX_WORDS}, digits + "
          f"lowercase: packed {tuple(packed.shape)} float32, finite; recognize gave "
          f"{len(results[0])} words; phase 15 in {time.perf_counter() - phase_start:.1f} s")
    return report, launches


# Phase 17: bfloat16 training. The CPU tests' bars
# (tests/test_torch_train_bf16.py): per gradient leaf the relative L2
# distance ||g - g_ref|| / ||g_ref||, leaves zero in exact arithmetic (read
# off a float32 step) held to rounding noise against the model's largest
# gradient, the running statistics per leaf, and the loss, relative.
BF16_GRAD_BAR = 0.5
BF16_ZERO_BAR = 3.3e-2
BF16_STATS_BAR = 6.8e-3
BF16_LOSS_BAR = 1e-3
# The CRAFT steps on the meshes (the timed steps are phase 11's sizes), and
# the CRNN's learning rate in the three fit steps.
BF16_MESH_CRAFT = (2, 256, 256)
BF16_FIT_CRNN_LR = 3e-4


def captured_step(trainer, batch, bridge):
    """One train step: its loss, the gradients and the running statistics
    after it, as numpy leaves of the JAX tree layout."""
    loss = trainer.train_step(batch)
    return {"loss": loss, "grads": gradient_leaves(trainer.model, bridge),
            "stats": dict(tree_leaves(bridge(trainer.model).get("batch_stats", {})))}


def zero_gradient_leaves(step):
    """The leaves of a float32 step's gradients below 1e-4 of its largest:
    zero in exact arithmetic."""
    largest = max(float(np.abs(v).max()) for v in step["grads"].values())
    return {k for k, v in step["grads"].items() if float(np.abs(v).max()) <= 1e-4 * largest}


def bf16_step_distance(what, step, ref, zero):
    """``step`` against ``ref`` under the CPU tests' bars; returns a summary,
    raises past a bar."""

    def l2(a, b):
        return float(np.linalg.norm(a.astype(np.float64) - b)) / max(
            float(np.linalg.norm(b.astype(np.float64))), 1e-12)

    loss = abs(step["loss"] - ref["loss"]) / abs(ref["loss"])
    largest = max(float(np.abs(v).max()) for v in ref["grads"].values())
    grads = {k: l2(step["grads"][k], v) for k, v in ref["grads"].items() if k not in zero}
    noise = max((float(np.abs(step["grads"][k]).max()) / largest for k in zero), default=0.0)
    stats = max((l2(step["stats"][k], v) for k, v in ref["stats"].items()), default=0.0)
    leaf = max(grads, key=grads.get)
    if not (loss <= BF16_LOSS_BAR and grads[leaf] <= BF16_GRAD_BAR and noise <= BF16_ZERO_BAR
            and stats <= BF16_STATS_BAR):
        raise AssertionError(f"{what}: loss {loss:.3e}, worst leaf {leaf} {grads[leaf]:.3e}, "
                             f"zero leaves {noise:.3e}, statistics {stats:.3e}")
    return (f"loss within {loss:.2e} relative, worst gradient leaf {leaf} at {grads[leaf]:.3e} "
            f"(median {statistics.median(grads.values()):.3e}; {len(zero)} zero leaves at "
            f"{noise:.2e} of the largest |g|), statistics within {stats:.2e}")


class CheckedConvs:
    """``conv_cuda`` as a CRAFT module sees it, with every ``conv_chain``
    call also run through the plain chain on the same tensors and held to
    its bars: phase 15's for a bf16 input (``check_bf16``), phase 3's
    ``CONV_BAR`` for a float32 one; the kernel's own wrapper runs and counts
    its launches. ``record`` collects (layers, shape) per call; ``what``
    names the path in a failure."""

    def __init__(self, conv_cuda, record, what="trained folded bf16 chain"):
        self._module, self._record, self._what = conv_cuda, record, what

    def __getattr__(self, name):
        return getattr(self._module, name)

    def conv_chain(self, x, convs, pool=False, tap_prepool=False):
        out = self._module.conv_chain(x, convs, pool=pool, tap_prepool=tap_prepool)
        ref = self._module.conv_chain_plain(x, convs, pool=pool, tap_prepool=tap_prepool)
        pairs = zip(out, ref) if tap_prepool else ((out, ref),)
        for got, want in pairs:
            if x.dtype == torch.bfloat16:
                check_bf16(self._module, self._what, got, want, len(convs))
            else:
                check_close(f"{self._what} {tuple(x.shape)}", got, want, CONV_BAR)
        self._record.append((len(convs), tuple(x.shape)))
        return out


def bf16_training_phase(card, float32_steps, scenes, wrappers):
    """Phase 17: both trainers on bfloat16 models. Returns the kernels'
    launches in the folded bf16 forward and ``recognize_many`` of the
    bf16-trained weights."""
    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, parallel, weights
    from keras_ocr_tpu_torch.models import craft as craft_module
    from keras_ocr_tpu_torch.models.craft import fold_bn_state_dict
    from keras_ocr_tpu_torch.models.crnn import DEFAULT_BUILD_PARAMS
    from keras_ocr_tpu_torch.ops import cc, cc_cuda, conv_cuda
    from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer

    phase_start = time.perf_counter()
    device = torch.device("cuda")
    bf16 = torch.bfloat16
    rng = np.random.RandomState(17)
    no_dropout = dict(DEFAULT_BUILD_PARAMS, dropout=0.0)
    models = {
        "CRNN": (RecognizerTrainer, weights.crnn_variables,
                 lambda on, dtype: Recognizer(None, None, no_dropout, dtype, device=on, seed=3)),
        "CRAFT": (DetectorTrainer, weights.craft_variables,
                  lambda on, dtype: Detector(weights=None, width=TRAIN_CRAFT_WIDTH,
                                             compute_dtype=dtype, device=on, seed=4)),
    }
    parity_batches = {"CRNN": crnn_batch(rng, 8, 48, 36),
                      "CRAFT": craft_batch(rng, *TRAIN_CRAFT_PARITY)}
    mesh_batches = {"CRNN": parity_batches["CRNN"], "CRAFT": craft_batch(rng, *BF16_MESH_CRAFT)}
    mesh_sizes = {"CRNN": "batch 8", "CRAFT": "x".join(map(str, BF16_MESH_CRAFT))}
    meshes = {"create_mesh()": parallel.create_mesh(),
              "two replicas": parallel.create_mesh(devices=[device, device])}

    # (a) One bf16 step on the card against the CPU's from one state (the
    # zero leaves read off the CPU's float32 step); (b) one bf16 step on
    # each mesh against the step without one.
    for what, (trainer_cls, bridge, make) in models.items():
        card_model = make(device, bf16)
        state = bridge(card_model.model)
        cpu_model = make("cpu", bf16).load_variables(state)
        zero = zero_gradient_leaves(captured_step(
            trainer_cls(make("cpu", torch.float32).load_variables(state)),
            parity_batches[what], bridge))
        card_step = captured_step(trainer_cls(card_model), parity_batches[what], bridge)
        cpu_step = captured_step(trainer_cls(cpu_model), parity_batches[what], bridge)
        if {p.dtype for p in card_model.model.parameters()} != {torch.float32}:
            raise AssertionError(f"bf16 {what}: parameters left float32")
        summary = bf16_step_distance(f"bf16 {what} card vs CPU", card_step, cpu_step, zero)
        batch = mesh_batches[what]
        plain = captured_step(trainer_cls(make(device, bf16).load_variables(state)), batch,
                              bridge)
        on_meshes = "; ".join(
            f"{label}: " + bf16_step_distance(
                f"bf16 {what} on the {label} mesh", captured_step(
                    trainer_cls(make(device, bf16).load_variables(state), mesh=mesh), batch,
                    bridge), plain, zero) for label, mesh in meshes.items())
        print(f"bf16 training ({card}), {what} step (float32 parameters), card vs CPU from one "
              f"state at phase 11's size: {summary}; on meshes against no mesh "
              f"({mesh_sizes[what]}): {on_meshes}")
        del card_model, cpu_model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Step ms (CUDA events, median of 10; B0 of 3) and peak memory,
    # float32 and bf16 in turns, then three fit steps per model.
    def b0(on, dtype):
        return efficientnet_detector("efficientnetb0", on, seed=5, compute_dtype=dtype)[0]

    size, height, width = TRAIN_CRAFT_TIMED
    craft_step_batch = craft_batch(rng, size, height, width)
    timed = {f"CRNN batch {b}": (RecognizerTrainer, lambda on, dtype: Recognizer(
                 None, None, DEFAULT_BUILD_PARAMS, dtype, device=on, seed=6),
                 crnn_batch(rng, b, 48, 36), 10) for b in TRAIN_CRNN_BATCHES}
    timed["VGG CRAFT"] = DetectorTrainer, models["CRAFT"][2], craft_step_batch, 10
    timed["B0 CRAFT"] = DetectorTrainer, b0, craft_step_batch, 3
    step_ms, peak_gb, trained, fits = {}, {}, {}, {}
    for label, (trainer_cls, make, batch, runs) in timed.items():
        for dtype in (torch.float32, bf16):
            trainer = trainer_cls(make(device, dtype))
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step_ms[label, dtype] = cuda_median_ms(lambda: trainer.train_step(batch), runs=runs)
            peak_gb[label, dtype] = (torch.cuda.max_memory_allocated() - resident) / 1e9
            if dtype == bf16 and label != "CRNN batch 64":
                # compile(): RMSprop at 1e-3 can overshoot the CRNN's CTC
                # loss on one fixed batch within 3 steps.
                fresh = make(device, dtype).compile(
                    learning_rate=BF16_FIT_CRNN_LR if label.startswith("CRNN") else 1e-3)
                fits[label] = fresh.fit(iter([batch] * 3), steps_per_epoch=1, epochs=3)
                trained[label] = fresh
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    for label, history in fits.items():
        if not (np.isfinite(history).all() and history[-1] < history[0]):
            raise AssertionError(f"bf16 {label}: fit losses on one batch did not fall: {history}")
    print(f"bf16 training ({card}): train step ms float32 / bfloat16 (median of 10, B0 of 3; "
          f"peak GB above the resident model in brackets): " + "; ".join(
              f"{label} {step_ms[label, torch.float32]:.3f} ({peak_gb[label, torch.float32]:.2f})"
              f" / {step_ms[label, bf16]:.3f} ({peak_gb[label, bf16]:.2f}), "
              f"{step_ms[label, torch.float32] / step_ms[label, bf16]:.2f}x" for label in timed)
          + f"; phase 11's float32: CRNN {float32_steps['crnn 8']:.3f} / "
          f"{float32_steps['crnn 64']:.3f} ms, CRAFT {float32_steps['craft']:.3f} ms; fit "
          f"3 steps on one batch, bf16: " + "; ".join(
              f"{label} {[round(h, 5) for h in history]}" for label, history in fits.items()))

    # (d) The bf16-trained VGG detector folded and run through the folded
    # bf16 forward and one recognize_many with the bf16-trained CRNN: the
    # conv kernel's bf16 mode and both sweep entries, each call held to its
    # plain version, launches counted from zero.
    standard = trained["VGG CRAFT"].detector
    folded = Detector(weights=None, width=TRAIN_CRAFT_WIDTH, fold_bn=True, compute_dtype=bf16,
                      device=device)
    folded.model.load_state_dict(fold_bn_state_dict(standard.model.state_dict()))
    pipeline = Pipeline(folded, trained["CRNN batch 8"].recognizer, scale=2)
    for wrapper in wrappers.values():
        wrapper.launches = 0
    sweep_calls, conv_calls = [], []
    undo = checked_sweeps(cc, cc_cuda, sweep_calls)
    craft_module.conv_cuda = CheckedConvs(conv_cuda, conv_calls)
    try:
        with torch.inference_mode():
            x = craft_input(pipeline, scenes[:2])
            heatmaps = folded.model(x)
            reference = standard.model(x)
        results = pipeline.recognize_many(scenes[:8], batch_size=8)
    finally:
        craft_module.conv_cuda = conv_cuda
        undo()
    check_results(results, 8)
    launches = {f"{name}_bf16" if name.startswith("conv") else name: wrapper.launches
                for name, wrapper in wrappers.items()}
    if min(launches.values()) <= 0 or heatmaps.dtype != torch.float32 \
            or not bool(torch.isfinite(heatmaps).all()):
        raise AssertionError(f"trained folded bf16 path: launches {launches}, heatmaps "
                             f"{heatmaps.dtype}")
    print(f"bf16 training ({card}): the bf16-trained VGG CRAFT folded (fold_bn_state_dict): "
          f"heatmaps of 2 scenes (960x1280) {float((heatmaps - reference).abs().max()):.3e} max, "
          f"{float((heatmaps - reference).abs().mean()):.3e} mean from the standard bf16 graph; "
          f"with the bf16-trained CRNN, recognize_many of 8 scenes: "
          f"{sum(len(r) for r in results)} words; {len(conv_calls)} conv_chain calls within "
          f"phase 15's bars of the plain bf16 chain, {len(sweep_calls)} sweep calls equal to "
          f"their plain versions; launches {launches}; phase 17 in "
          f"{time.perf_counter() - phase_start:.1f} s")
    return launches


# Phase 19: synthetic data at keras-ocr's end-to-end training example
# settings: 640x640 scenes, font sizes 60-120, a 50 px margin, small X/Y
# tilts and +-15 degrees about Z; its text alphabet and the recognizer's
# (the lowercased set), at most 10 characters a crop. The scenes timed one
# at a time, the steps of each trainer, their batch sizes, the scenes of
# the folded pipeline, and the sha256 of the default font's render of one
# fixed string (tests/test_torch_fonts.py holds the same constant).
SYNTH_SIZE = 640
SYNTH_FONT_SIZE = (60, 120)
SYNTH_MARGIN = 50
SYNTH_ROTATIONS = {"rotationX": (-0.05, 0.05), "rotationY": (-0.05, 0.05), "rotationZ": (-15, 15)}
SYNTH_ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ!?. "
SYNTH_MAX_LENGTH = 10
SYNTH_TIMED = 16
SYNTH_DETECTOR_BATCH = 4
SYNTH_RECOGNIZER_BATCH = 8
SYNTH_PIPELINE_SCENES = 4
SYNTH_DIR = os.path.join(ROOT, "build", "synthetic")
RENDER_SHA256 = "80b4dc795d8746d0cbbcd152dd2d0a1d9a292df104670e7244b1b49761171275"


def reference_render():
    """The default font at 40 px drawn into a 96 x 640 RGBA canvas, as
    tests/test_torch_fonts.py draws it."""
    from keras_ocr_tpu_torch.data import fonts, raster

    font = fonts.load_default(40)
    canvas = np.zeros((96, 640, 4), dtype=np.uint8)
    canvas[..., :3] = 255
    x = 8.0
    for character in "Synthetic fi text 0123 @&Q":
        mask, (dx, dy) = font.getmask2(character)
        raster.draw_bitmap(canvas, mask, (20, 30, 40, 255), (int(x) + dx, 20 + dy))
        x += font.getsize(character)[0][0] + font.getsize(character)[1][0]
    return canvas


def synthetic_phase(card, wrappers):
    """Phase 19: the port's synthetic scenes (numpy TrueType reader and
    rasteriser, no PIL) into both trainers and the folded pipeline.
    Returns the kernels' launches in the folded pipeline's run."""
    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, data_generation, detection
    from keras_ocr_tpu_torch import tools
    from keras_ocr_tpu_torch.data import fonts, generation
    from keras_ocr_tpu_torch.models import craft as craft_module
    from keras_ocr_tpu_torch.models.craft import fold_bn_state_dict
    from keras_ocr_tpu_torch.ops import cc, cc_cuda, conv_cuda
    from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer

    phase_start = time.perf_counter()
    device = torch.device("cuda")
    digest = hashlib.sha256(reference_render().tobytes()).hexdigest()
    if digest != RENDER_SHA256:
        raise AssertionError(f"the default font's render: sha256 {digest}, the CPU test's "
                             f"{RENDER_SHA256}")
    shutil.rmtree(SYNTH_DIR, ignore_errors=True)
    os.makedirs(SYNTH_DIR)
    font_path = os.path.join(SYNTH_DIR, "default.ttf")
    with open(font_path, "wb") as f:
        f.write(fonts.default_font_bytes())
    backgrounds = [tools.read(os.path.join(ARTIFACT, name))
                   for name in sorted(os.listdir(ARTIFACT)) if name.endswith(".png")]
    backgrounds.append(tools.read(SERVING_JPEG))
    if not data_generation.font_supports_alphabet(font_path, SYNTH_ALPHABET.strip()):
        raise AssertionError("the default font lacks a character of the alphabet")

    def scenes():
        text = data_generation.get_text_generator(alphabet=SYNTH_ALPHABET)
        return data_generation.get_image_generator(
            height=SYNTH_SIZE, width=SYNTH_SIZE, font_groups={SYNTH_ALPHABET: [font_path]},
            text_generator=text, font_size=SYNTH_FONT_SIZE, backgrounds=list(backgrounds),
            margin=SYNTH_MARGIN, **SYNTH_ROTATIONS)

    opened = []
    open_font = generation._open_font

    def recording_open(path, size):
        opened.append(open_font(path, size))
        return opened[-1]

    generation._open_font = recording_open
    try:
        # Host ms of a scene, one at a time, and the glyph cache's share.
        random.seed(19)
        np.random.seed(19)
        generator = scenes()
        scene_ms, characters = [], 0
        for _ in range(SYNTH_TIMED):
            start = time.perf_counter()
            image, lines = next(generator)
            scene_ms.append((time.perf_counter() - start) * 1e3)
            characters += sum(len(line) for line in lines)
            if image.shape != (SYNTH_SIZE, SYNTH_SIZE, 3) or image.dtype != np.uint8:
                raise AssertionError(f"synthetic scene {image.shape} {image.dtype}")
            for line in lines:
                for box, character in line:
                    if box.shape != (4, 2) or not np.isfinite(box).all() or len(character) != 1:
                        raise AssertionError(f"synthetic box ({box}, {character!r})")
        hits = sum(font.hits for font in opened)
        misses = sum(font.misses for font in opened)
        if not characters or not misses:
            raise AssertionError(f"{SYNTH_TIMED} synthetic scenes drew {characters} characters")
        print(f"synthetic ({card}): get_image_generator {SYNTH_SIZE}x{SYNTH_SIZE}, font sizes "
              f"{SYNTH_FONT_SIZE}, margin {SYNTH_MARGIN}, {SYNTH_ROTATIONS}, the default font "
              f"written to a .ttf, {len(backgrounds)} backgrounds: host ms per scene median "
              f"{statistics.median(scene_ms):.1f} (min {min(scene_ms):.1f}, max "
              f"{max(scene_ms):.1f}) of {SYNTH_TIMED}, {characters} characters; glyph cache "
              f"hits {hits} of {hits + misses} lookups ({100 * hits / (hits + misses):.1f}%; "
              f"host CPU {host_cpu()}); render sha256 equal to the CPU test's")

        # Three DetectorTrainer steps on scenes, batch 4.
        random.seed(20)
        np.random.seed(20)
        detector = Detector(weights=None, width=1.0, device=device, seed=19)
        batches = detector.get_batch_generator(scenes(), batch_size=SYNTH_DETECTOR_BATCH)
        craft = fed_steps(DetectorTrainer(detector), batches,
                          {"draw_text_image": (generation, "draw_text_image"),
                           "uniform_contour": (generation, "get_maximum_uniform_contour"),
                           "compute_maps": (detection, "compute_maps")})
        print(f"synthetic ({card}): get_image_generator -> Detector.get_batch_generator("
              f"{SYNTH_DETECTOR_BATCH}) -> DetectorTrainer.fit, {DATA_STEPS} steps, full-width "
              f"VGG CRAFT: {fit_line(craft, 6)}")

        # Three RecognizerTrainer steps on the scenes' line crops, batch 8.
        random.seed(21)
        np.random.seed(21)
        alphabet = "".join(sorted(set(SYNTH_ALPHABET.lower())))
        recognizer = Recognizer(alphabet, None, device=device, seed=19)
        crops = data_generation.convert_image_generator_to_recognizer_input(
            scenes(), max_string_length=min(recognizer.max_string_length(), SYNTH_MAX_LENGTH),
            target_width=recognizer.input_shape[1], target_height=recognizer.input_shape[0],
            margin=1)
        crnn = fed_steps(RecognizerTrainer(recognizer),
                         recognizer.get_batch_generator(crops, batch_size=SYNTH_RECOGNIZER_BATCH,
                                                        lowercase=True),
                         {"draw_text_image": (generation, "draw_text_image"),
                          "warpBox": (tools, "warpBox")})
        print(f"synthetic ({card}): convert_image_generator_to_recognizer_input -> "
              f"Recognizer.get_batch_generator({SYNTH_RECOGNIZER_BATCH}, lowercase) -> "
              f"RecognizerTrainer.fit, {DATA_STEPS} steps, full-width CRNN, alphabet "
              f"{alphabet!r}: {fit_line(crnn, 4)}")

        random.seed(22)
        np.random.seed(22)
        generator = scenes()
        images = [next(generator)[0] for _ in range(SYNTH_PIPELINE_SCENES)]
    finally:
        generation._open_font = open_font
        shutil.rmtree(SYNTH_DIR, ignore_errors=True)

    # The synthetic-trained detector, BatchNorm folded, and the trained CRNN
    # read 4 generated scenes: every conv chain held to its plain version
    # (phase 3's bar), every sweep call equal to its plain version, the
    # launches counted from zero.
    folded = Detector(weights=None, width=1.0, fold_bn=True, device=device)
    folded.model.load_state_dict(fold_bn_state_dict(detector.model.state_dict()))
    pipeline = Pipeline(folded, recognizer, scale=2)
    for wrapper in wrappers.values():
        wrapper.launches = 0
    sweep_calls, conv_calls = [], []
    undo = checked_sweeps(cc, cc_cuda, sweep_calls)
    craft_module.conv_cuda = CheckedConvs(conv_cuda, conv_calls, what="synthetic folded chain")
    try:
        results = pipeline.recognize(images)
    finally:
        craft_module.conv_cuda = conv_cuda
        undo()
    check_results(results, SYNTH_PIPELINE_SCENES)
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the folded pipeline on synthetic scenes launched {launches}")
    print(f"synthetic ({card}): Pipeline(Detector(fold_bn=True) of the synthetic-trained "
          f"weights, the synthetic-trained CRNN).recognize of {SYNTH_PIPELINE_SCENES} generated "
          f"scenes: {sum(len(r) for r in results)} words; {len(conv_calls)} conv_chain calls "
          f"within {CONV_BAR} of the plain chain, {len(sweep_calls)} sweep calls equal to their "
          f"plain versions; launches {launches}; phase 19 in "
          f"{time.perf_counter() - phase_start:.1f} s")
    return launches

# Phase 20: the GIF decoder and the JPEG writer of the ICDAR 2019 loader.
GIF_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "gif")
ICDAR_2019_DIR = os.path.join(ROOT, "build", "icdar2019_cache")
CODEC_TIMED = 5


def codecs_phase(card):
    """Phase 20: the GIF fixtures decoded to the sha256 of PIL's decode,
    each written by the JPEG encoder (its bytes against PIL's file, else
    its pixels decoded by the port), decode MB/s and encode ms per
    megapixel on a 640x480 GIF, and the ICDAR 2019 loader's conversion of
    a cache of the fixtures with the network refused."""
    from keras_ocr_tpu_torch import tools
    from keras_ocr_tpu_torch.data import datasets

    phase_start = time.perf_counter()
    with open(os.path.join(GIF_FIXTURES, "hashes.json"), encoding="utf8") as f:
        hashes = json.load(f)
    kinds = {}
    for name, expected in sorted(hashes.items()):
        image = tools.read(os.path.join(GIF_FIXTURES, name))
        digest = hashlib.sha256(image.tobytes()).hexdigest()
        if list(image.shape) != expected["shape"] or digest != expected["decoded_sha256"]:
            raise AssertionError(f"{name}: decoded {image.shape} sha256 {digest}, PIL's "
                                 f"{expected['shape']} {expected['decoded_sha256']}")
        encoded = tools._encode_jpeg(image)
        if hashlib.sha256(encoded).hexdigest() == expected["jpeg_sha256"]:
            kinds[name] = "bytes"
        elif hashlib.sha256(tools.decode_jpeg(encoded).tobytes()).hexdigest() \
                == expected["jpeg_decoded_sha256"]:
            kinds[name] = "pixels"
        else:
            raise AssertionError(f"{name}: the JPEG encoder's file decodes to other pixels "
                                 "than PIL's file")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_gif_fixtures import write_gif

    yy, xx = np.mgrid[:480, :640]
    scene = (((xx // 7) ^ (yy // 5)) % 61 + (xx * yy) % 3).astype(np.uint8)
    palette = np.random.RandomState(20).randint(0, 256, (256, 3)).astype(np.uint8)
    blob = write_gif(scene, global_palette=palette, min_size=8)
    decode_s, decoded = median_seconds(lambda: tools.decode_gif(blob), runs=CODEC_TIMED)
    if not np.array_equal(decoded, palette[scene]):
        raise AssertionError("the 640x480 GIF did not decode to its palette's colours")
    encode_s, _ = median_seconds(lambda: tools._encode_jpeg(decoded), runs=CODEC_TIMED)
    megapixels = decoded.shape[0] * decoded.shape[1] / 1e6

    shutil.rmtree(ICDAR_2019_DIR, ignore_errors=True)
    main_dir = os.path.join(ICDAR_2019_DIR, "icdar2019")
    entries = []
    for index, name in enumerate(sorted(hashes)):
        part = "ImagesPart1" if index % 2 else "ImagesPart2"
        os.makedirs(os.path.join(main_dir, part), exist_ok=True)
        shutil.copyfile(os.path.join(GIF_FIXTURES, name),
                        os.path.join(main_dir, part, f"tr_img_{index:05d}.gif"))
        entries.append({"filepath": f"{part}/tr_img_{index:05d}.jpg", "percent_complete": 1.0,
                        "lines": [{"line": [[[1, 1], [9, 1], [9, 7], [1, 7]]]}]})
    with open(os.path.join(main_dir, "mlt2019_dataset.json"), "w", encoding="utf8") as f:
        json.dump({"dataset": entries}, f)
    extract = datasets.tools.download_and_extract
    datasets.tools.download_and_extract = lambda *args, **kwargs: None
    try:
        with offline(os.path.join(ICDAR_2019_DIR, "weights")) as urls, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            start = time.perf_counter()
            records = datasets.get_icdar_2019_semisupervised_dataset(cache_dir=ICDAR_2019_DIR)
            convert_s = time.perf_counter() - start
        if urls:
            raise AssertionError(f"the ICDAR 2019 loader asked the network for {urls}")
        for index, name in enumerate(sorted(hashes)):
            path = records[index][0]
            with open(path, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != hashes[name]["jpeg_sha256"] \
                        and kinds[name] == "bytes":
                    raise AssertionError(f"{path}: not the bytes PIL writes for {name}")
        left = [n for _, _, files in os.walk(main_dir) for n in files if n.endswith(".gif")]
        if len(records) != len(hashes) or left:
            raise AssertionError(f"ICDAR 2019: {len(records)} records, GIFs left: {left}")
    finally:
        datasets.tools.download_and_extract = extract
        shutil.rmtree(ICDAR_2019_DIR, ignore_errors=True)
    equal = sorted(n for n, k in kinds.items() if k == "bytes")
    which = "bytes" if len(equal) == len(kinds) else "pixels"
    print(f"codecs ({card}): {len(hashes)} GIF fixtures decoded to the sha256 of PIL's "
          f"decode; the JPEG encoder's files equal PIL's {which} "
          f"({len(equal)} of {len(kinds)} byte for byte: {kinds}); a 640x480 8-bit GIF "
          f"({len(blob)} bytes) decodes in {decode_s * 1e3:.1f} ms = "
          f"{decoded.nbytes / 1e6 / decode_s:.2f} MB/s of RGB out, "
          f"{len(blob) / 1e6 / decode_s:.2f} MB/s of file in (median of {CODEC_TIMED}), "
          f"encodes to JPEG in "
          f"{encode_s * 1e3 / megapixels:.1f} ms per megapixel (host CPU {host_cpu()}); the "
          f"ICDAR 2019 loader converted {len(records)} GIFs in {convert_s:.3f} s with the "
          f"network refused; phase 20 in {time.perf_counter() - phase_start:.1f} s")


# Phase 22: the scan and photo formats of tools.read.
IMAGE_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "images")
IMAGE_TIMED = 5


def write_ppm(rgb):
    """A raw PPM (P6, maxval 255) of (H, W, 3) uint8."""
    return b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]) + rgb.tobytes()


def write_bmp24(rgb):
    """A 24-bit BI_RGB BMP (BITMAPINFOHEADER, bottom-up rows)."""
    height, width = rgb.shape[:2]
    stride = (width * 3 + 3) & ~3
    rows = np.zeros((height, stride), np.uint8)
    rows[:, : width * 3] = rgb[::-1, :, ::-1].reshape(height, -1)
    info = struct.pack("<IiiHHIIiiII", 40, width, height, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + info + rows.tobytes()


def write_tiff_rgb(rgb):
    """An uncompressed little-endian RGB TIFF: the IFD at byte 8, then
    BitsPerSample's three values, then the one strip."""
    height, width = rgb.shape[:2]
    bits_at = 8 + 2 + 12 * 9 + 4
    entries = ((256, 4, width), (257, 4, height), (258, 3, bits_at), (259, 3, 1), (262, 3, 2),
               (273, 4, bits_at + 6), (277, 3, 3), (278, 4, height), (279, 4, rgb.size))
    ifd = struct.pack("<H", len(entries))
    for tag, kind, value in entries:
        count = 3 if tag == 258 else 1
        field = struct.pack("<I" if kind == 4 or count > 1 else "<HH", value, *(
            () if kind == 4 or count > 1 else (0,)))
        ifd += struct.pack("<HHI", tag, kind, count) + field
    return (b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0)
            + struct.pack("<HHH", 8, 8, 8) + rgb.tobytes())


def image_formats_phase(card, folded_pipeline, golden_folded, golden_scenes, pass_fraction,
                        wrappers):
    """Phase 22: every fixture of ``tests/fixtures/images`` decoded to the
    sha256 of PIL's decode; host decode ms and MB/s of the Group 4 page
    and a 640x480 LZW RGB TIFF (median of 5); the full-width folded
    pipeline's ``recognize`` of the page by path against its decoded
    array (words and boxes equal), with the decode's share of the call;
    the golden scenes written as PPM, BMP and TIFF read by path through the
    golden folded pipeline (``pass_fraction``, words equal to the PNG
    run's). Returns the launches of the kernels, counted from zero."""
    from keras_ocr_tpu_torch import tools
    from keras_ocr_tpu_torch.utils import golden

    phase_start = time.perf_counter()
    with open(os.path.join(IMAGE_FIXTURES, "hashes.json"), encoding="utf8") as f:
        hashes = json.load(f)
    for name, expected in sorted(hashes.items()):
        image = tools.read(os.path.join(IMAGE_FIXTURES, name))
        digest = hashlib.sha256(image.tobytes()).hexdigest()
        if list(image.shape) != expected["shape"] or digest != expected["decoded_sha256"]:
            raise AssertionError(f"{name}: decoded {image.shape} sha256 {digest}, PIL's "
                                 f"{expected['shape']} {expected['decoded_sha256']}")
    page_path = os.path.join(IMAGE_FIXTURES, "page_g4.tif")
    with open(page_path, "rb") as f:
        page_blob = f.read()
    page_s, page = median_seconds(lambda: tools.decode_tiff(page_blob), runs=IMAGE_TIMED)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_image_fixtures import scene, write_tiff

    photo = scene(480, 640)
    lzw_blob = write_tiff(photo, photometric=2, compression=5, rows_per_strip=64)
    lzw_s, lzw = median_seconds(lambda: tools.decode_tiff(lzw_blob), runs=IMAGE_TIMED)
    if not np.array_equal(lzw, photo):
        raise AssertionError("the 640x480 LZW TIFF did not decode to its pixels")
    print(f"image formats ({card}): {len(hashes)} fixtures (TIFF, BMP, PNM, CMYK/YCCK JPEG) "
          f"decoded to the sha256 of PIL's decode; host decode (median of {IMAGE_TIMED}, host "
          f"CPU {host_cpu()}): the 2550x3300 Group 4 page ({len(page_blob)} bytes) "
          f"{page_s * 1e3:.1f} ms = {page.nbytes / 1e6 / page_s:.2f} MB/s of RGB out, a "
          f"640x480 LZW RGB TIFF ({len(lzw_blob)} bytes) {lzw_s * 1e3:.1f} ms = "
          f"{lzw.nbytes / 1e6 / lzw_s:.2f} MB/s of RGB out")

    for wrapper in wrappers.values():
        wrapper.launches = 0
    by_path = folded_pipeline.recognize([page_path])
    torch.cuda.synchronize()
    start = time.perf_counter()
    by_path = folded_pipeline.recognize([page_path])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - start
    by_array = folded_pipeline.recognize([page])
    if [w for w, _ in by_path[0]] != [w for w, _ in by_array[0]] or not all(
            np.array_equal(a, b) for (_, a), (_, b) in zip(by_path[0], by_array[0])):
        raise AssertionError("the page read by path gave other words or boxes than its array")
    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        expected = json.load(f)["scenes"]
    pngs = [os.path.join(ARTIFACT, entry["image"]) for entry in expected]
    words = {"png": [[w for w, _ in r] for r in golden_folded.recognize(pngs)]}
    fractions = {}
    with tempfile.TemporaryDirectory() as folder:
        for kind, writer in (("ppm", write_ppm), ("bmp", write_bmp24), ("tif", write_tiff_rgb)):
            paths = []
            for index, png in enumerate(pngs):
                path = os.path.join(folder, f"scene_{index:02d}.{kind}")
                with open(path, "wb") as f:
                    f.write(writer(golden_scenes[index]))
                if not np.array_equal(tools.read(path), golden_scenes[index]):
                    raise AssertionError(f"{path} did not decode to the scene's pixels")
                paths.append(path)
            words[kind] = [[w for w, _ in r] for r in golden_folded.recognize(paths)]
            hits = sum(golden._word_match_fraction(entry["words"], found) * len(entry["words"])
                       for entry, found in zip(expected, words[kind]))
            fractions[kind] = hits / max(sum(len(e["words"]) for e in expected), 1)
            if words[kind] != words["png"] or fractions[kind] < pass_fraction:
                raise AssertionError(f"golden scenes as {kind}: fraction {fractions[kind]} "
                                     f"(pass >= {pass_fraction}), words equal to the PNG "
                                     f"run's: {words[kind] == words['png']}")
    launches = {name: w.launches for name, w in wrappers.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the folded path was never launched: {launches}")
    print(f"image formats, pipelines ({card}): the full-width folded pipeline's recognize of "
          f"the Group 4 page by path equals that of its decoded array ({len(by_path[0])} "
          f"words; random weights); the call {call_s * 1e3:.1f} ms, of which the host decode "
          f"{page_s * 1e3:.1f} ms = {page_s / call_s:.1%}; the golden folded pipeline read "
          f"the 12 scenes as PPM, BMP and TIFF with the PNG run's words, fractions "
          f"{ {k: round(v, 4) for k, v in fractions.items()} } (pass >= {pass_fraction}); "
          f"launches {launches}; phase 22 in {time.perf_counter() - phase_start:.1f} s")
    return launches


# Phase 23: WebP files through tools.read and the golden folded pipeline.
WEBP_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "webp")
WEBP_TIMED = 3


def webp_phase(card, golden_folded, pass_fraction, wrappers):
    """Phase 23: every fixture of ``tests/fixtures/webp`` decoded to the
    sha256 of PIL's decode; host decode ms and MB/s of RGB out of the 12
    golden scenes as lossy WebP and of scene 3 as lossless WebP (median of
    3); the golden folded pipeline's ``recognize`` of the 12 lossy scenes
    by path, with words and boxes equal to those of their decoded arrays
    and ``pass_fraction`` reached. Returns the launches of the kernels in
    the run by path, counted from zero."""
    from keras_ocr_tpu_torch import tools, webp
    from keras_ocr_tpu_torch.utils import golden

    phase_start = time.perf_counter()
    with open(os.path.join(WEBP_FIXTURES, "hashes.json"), encoding="utf8") as f:
        hashes = json.load(f)
    for name, expected in sorted(hashes.items()):
        image = tools.read(os.path.join(WEBP_FIXTURES, name))
        digest = hashlib.sha256(image.tobytes()).hexdigest()
        if list(image.shape) != expected["shape"] or digest != expected["decoded_sha256"]:
            raise AssertionError(f"{name}: decoded {image.shape} sha256 {digest}, PIL's "
                                 f"{expected['shape']} {expected['decoded_sha256']}")
    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        expected = json.load(f)["scenes"]
    paths = [os.path.join(WEBP_FIXTURES, entry["image"].replace(".png", ".webp"))
             for entry in expected]
    blobs = []
    for path in paths + [os.path.join(WEBP_FIXTURES, "scene_03_lossless.webp")]:
        with open(path, "rb") as f:
            blobs.append(f.read())
    lossy_s, scenes = median_seconds(lambda: [webp.decode_webp(b) for b in blobs[:-1]],
                                     runs=WEBP_TIMED)
    lossless_s, lossless = median_seconds(lambda: webp.decode_webp(blobs[-1]), runs=WEBP_TIMED)
    lossy_bytes = sum(image.nbytes for image in scenes)
    print(f"webp ({card}): {len(hashes)} fixtures (lossy, lossless, ALPH, animation) decoded "
          f"to the sha256 of PIL's decode; host decode (median of {WEBP_TIMED}, host CPU "
          f"{host_cpu()}): the 12 golden scenes as lossy WebP at quality 80 "
          f"({sum(len(b) for b in blobs[:-1])} bytes) {lossy_s * 1e3:.1f} ms in all, "
          f"{lossy_s * 1e3 / len(scenes):.1f} ms a scene = {lossy_bytes / 1e6 / lossy_s:.2f} "
          f"MB/s of RGB out; scene 3 as lossless WebP ({len(blobs[-1])} bytes) "
          f"{lossless_s * 1e3:.1f} ms = {lossless.nbytes / 1e6 / lossless_s:.2f} MB/s of RGB "
          f"out")

    for wrapper in wrappers.values():
        wrapper.launches = 0
    by_path = golden_folded.recognize(paths)
    launches = {name: w.launches for name, w in wrappers.items()}
    by_array = golden_folded.recognize(scenes)
    for index, (path_result, array_result) in enumerate(zip(by_path, by_array)):
        if [w for w, _ in path_result] != [w for w, _ in array_result] or not all(
                np.array_equal(a, b) for (_, a), (_, b) in zip(path_result, array_result)):
            raise AssertionError(f"scene {index} read by path gave other words or boxes than "
                                 f"its decoded array")
    words = [[w for w, _ in result] for result in by_path]
    hits = sum(golden._word_match_fraction(entry["words"], found) * len(entry["words"])
               for entry, found in zip(expected, words))
    fraction = hits / max(sum(len(entry["words"]) for entry in expected), 1)
    if fraction < pass_fraction:
        raise AssertionError(f"golden scenes as lossy WebP: fraction {fraction} "
                             f"(pass >= {pass_fraction})")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the folded path was never launched: {launches}")
    print(f"webp, pipeline ({card}): the golden folded pipeline read the 12 lossy WebP scenes "
          f"by path with the words and boxes of their decoded arrays, fraction "
          f"{fraction:.4f} (pass >= {pass_fraction}); launches {launches}; phase 23 in "
          f"{time.perf_counter() - phase_start:.1f} s")
    return launches


# Phase 24: the JPEG kinds of keras_ocr_tpu_torch/jpeg_modes.py, TGA and PCX.
JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")
JPEG_TIMED = 3


def jpeg_modes_phase(card, golden_folded, golden_images, pass_fraction, wrappers):
    """Phase 24: every fixture of ``tests/fixtures/jpeg`` decoded by path to
    the sha256 of PIL's decode; host decode ms and MB/s of RGB out (median
    of 3) of the 12 golden scenes as SOF9, of their Huffman twins (PIL's
    baseline files, rebuilt from the SOF9 files' coefficients and held to
    the same pixels), of scene 3 as SOF10, of a
    640x480 lossless JPEG and of scene 3 as run-length TGA and PCX (the
    last three written here, each held to its source pixels); the golden
    folded pipeline's ``recognize`` of the 12 SOF9 scenes by path, with
    words and boxes equal to those of their decoded arrays and
    ``pass_fraction`` reached. Returns the launches of the kernels in the
    run by path, counted from zero."""
    from keras_ocr_tpu_torch import codecs, tools
    from keras_ocr_tpu_torch.utils import golden

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import make_image_fixtures
    import make_jpeg_fixtures

    phase_start = time.perf_counter()
    with open(os.path.join(JPEG_FIXTURES, "hashes.json"), encoding="utf8") as f:
        hashes = json.load(f)
    for name, expected in sorted(hashes.items()):
        image = tools.read(os.path.join(JPEG_FIXTURES, name))
        digest = hashlib.sha256(image.tobytes()).hexdigest()
        if list(image.shape) != expected["shape"] or digest != expected["decoded_sha256"]:
            raise AssertionError(f"{name}: decoded {image.shape} sha256 {digest}, PIL's "
                                 f"{expected['shape']} {expected['decoded_sha256']}")
    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        expected = json.load(f)["scenes"]
    paths = [os.path.join(JPEG_FIXTURES, entry["image"].replace(".png", "_arith.jpg"))
             for entry in expected]
    blobs = []
    for path in paths + [os.path.join(JPEG_FIXTURES, "scene_03_arith_progressive.jpg")]:
        with open(path, "rb") as f:
            blobs.append(f.read())
    tiled = np.concatenate([np.concatenate(golden_images[0:2], 1),
                            np.concatenate(golden_images[2:4], 1)], 0)[:480, :640]
    lossless = make_jpeg_fixtures.lossless_jpeg([tiled[..., k] for k in range(3)], predictor=4)
    scene = golden_images[3]
    tga = make_image_fixtures.write_tga(scene, 10, 24)
    pcx = make_image_fixtures.write_pcx(scene, 8, 3)

    timed = {}

    def timing(label, fn, size):
        seconds, out = median_seconds(fn, runs=JPEG_TIMED)
        out = out if isinstance(out, list) else [out]
        timed[label] = (seconds, sum(image.nbytes for image in out), size)
        return out

    scenes = timing("12 golden scenes as SOF9", lambda: [tools.decode_jpeg(b)
                                                         for b in blobs[:-1]],
                    sum(len(b) for b in blobs[:-1]))
    twins = [make_jpeg_fixtures.huffman_jpeg(make_jpeg_fixtures.frame_of_jpeg(b))
             for b in blobs[:-1]]
    baseline = timing("their Huffman twins (baseline, SOF0)",
                      lambda: [tools.decode_jpeg(b) for b in twins], sum(map(len, twins)))
    if not all(np.array_equal(a, b) for a, b in zip(scenes, baseline)):
        raise AssertionError("a golden scene's Huffman twin decodes to other pixels")
    timing("scene 3 as SOF10", lambda: tools.decode_jpeg(blobs[-1]), len(blobs[-1]))
    for label, blob, decode, want in (
            ("640x480 lossless (predictor 4)", lossless, tools.decode_jpeg, tiled),
            ("scene 3 as run-length TGA", tga, codecs.decode_tga, scene),
            ("scene 3 as run-length PCX", pcx, codecs.decode_pcx, scene)):
        (out,) = timing(label, lambda b=blob, d=decode: d(b), len(blob))
        if not np.array_equal(out, want):
            raise AssertionError(f"{label}: the decode is not the source's pixels")
    print(f"jpeg modes ({card}): {len(hashes)} fixtures (arithmetic-coded, lossless, sampling "
          f"factors 3 and 4) decoded by path to the sha256 of PIL's decode; host decode "
          f"(median of {JPEG_TIMED}, host CPU {host_cpu()}): " + "; ".join(
              f"{label} ({size} bytes) {seconds * 1e3:.1f} ms = {nbytes / 1e6 / seconds:.2f} "
              f"MB/s of RGB out" for label, (seconds, nbytes, size) in timed.items()))

    for wrapper in wrappers.values():
        wrapper.launches = 0
    by_path = golden_folded.recognize(paths)
    launches = {name: w.launches for name, w in wrappers.items()}
    by_array = golden_folded.recognize(scenes)
    for index, (path_result, array_result) in enumerate(zip(by_path, by_array)):
        if [w for w, _ in path_result] != [w for w, _ in array_result] or not all(
                np.array_equal(a, b) for (_, a), (_, b) in zip(path_result, array_result)):
            raise AssertionError(f"scene {index} read by path gave other words or boxes than "
                                 f"its decoded array")
    words = [[w for w, _ in result] for result in by_path]
    hits = sum(golden._word_match_fraction(entry["words"], found) * len(entry["words"])
               for entry, found in zip(expected, words))
    fraction = hits / max(sum(len(entry["words"]) for entry in expected), 1)
    if fraction < pass_fraction:
        raise AssertionError(f"golden scenes as SOF9 JPEG: fraction {fraction} "
                             f"(pass >= {pass_fraction})")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the folded path was never launched: {launches}")
    print(f"jpeg modes, pipeline ({card}): the golden folded pipeline read the 12 SOF9 scenes "
          f"by path with the words and boxes of their decoded arrays, fraction "
          f"{fraction:.4f} (pass >= {pass_fraction}); launches {launches}; phase 24 in "
          f"{time.perf_counter() - phase_start:.1f} s")
    return launches


# Phase 25: JPEG 2000 files through tools.read and the folded pipelines.
JP2_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jp2")
JP2_TIMED = 3


def jpeg2000_phase(card, folded_pipeline, golden_folded, pass_fraction, wrappers):
    """Phase 25: every fixture of ``tests/fixtures/jp2`` decoded by path to
    the sha256 of PIL's decode; host decode ms and MB/s of RGB out (median
    of 3) of scene 3 as lossy 9/7 and lossless 5/3 JP2, and the 12 lossy
    scenes decoded once each; the golden folded pipeline's ``recognize`` of
    the 12 lossy scenes by path, words and boxes equal to those of their
    decoded arrays and ``pass_fraction`` reached; the 640x480 lossy photo
    read by the full-width folded pipeline by path and as its decoded array
    in turns (median of 3 each, words and boxes equal), the difference the
    decode's share of the call by path. Returns the launches of the
    kernels in the phase's pipeline runs, counted from zero."""
    from keras_ocr_tpu_torch import jpeg2000, tools
    from keras_ocr_tpu_torch.utils import golden

    phase_start = time.perf_counter()
    with open(os.path.join(JP2_FIXTURES, "hashes.json"), encoding="utf8") as f:
        hashes = json.load(f)
    for name, expected in sorted(hashes.items()):
        image = tools.read(os.path.join(JP2_FIXTURES, name))
        digest = hashlib.sha256(image.tobytes()).hexdigest()
        if list(image.shape) != expected["shape"] or digest != expected["decoded_sha256"]:
            raise AssertionError(f"{name}: decoded {image.shape} sha256 {digest}, PIL's "
                                 f"{expected['shape']} {expected['decoded_sha256']}")
    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        expected = json.load(f)["scenes"]
    paths = [os.path.join(JP2_FIXTURES, entry["image"].replace(".png", ".jp2"))
             for entry in expected]
    blobs = {}
    for name in ("scene_03.jp2", "scene_03_lossless.jp2", "photo_640x480.jp2"):
        with open(os.path.join(JP2_FIXTURES, name), "rb") as f:
            blobs[name] = f.read()
    timed = {}
    for label, name in (("scene 3 as lossy 9/7 JP2", "scene_03.jp2"),
                        ("scene 3 as lossless 5/3 JP2", "scene_03_lossless.jp2"),
                        ("the 640x480 photo as lossy 9/7 JP2", "photo_640x480.jp2")):
        seconds, out = median_seconds(lambda b=blobs[name]: jpeg2000.decode_jpeg2000(b),
                                      runs=JP2_TIMED)
        timed[label] = (seconds, out.nbytes, len(blobs[name]))
    start = time.perf_counter()
    scenes = [tools.read(path) for path in paths]
    scenes_s = time.perf_counter() - start
    scene_bytes = sum(os.path.getsize(path) for path in paths)
    print(f"jpeg2000 ({card}): {len(hashes)} fixtures (JP2 and raw codestreams) decoded by "
          f"path to the sha256 of PIL's decode; host decode (median of {JP2_TIMED}, host CPU "
          f"{host_cpu()}): " + "; ".join(
              f"{label} ({size} bytes) {seconds * 1e3:.1f} ms = {nbytes / 1e6 / seconds:.2f} "
              f"MB/s of RGB out" for label, (seconds, nbytes, size) in timed.items())
          + f"; the 12 lossy golden scenes ({scene_bytes} bytes) once each "
          f"{scenes_s * 1e3:.1f} ms in all = "
          f"{sum(s.nbytes for s in scenes) / 1e6 / scenes_s:.2f} MB/s of RGB out")

    for wrapper in wrappers.values():
        wrapper.launches = 0
    by_path = golden_folded.recognize(paths)
    photo_path = os.path.join(JP2_FIXTURES, "photo_640x480.jp2")
    photo = tools.read(photo_path)
    folded_pipeline.recognize([photo])
    path_s, array_s, photo_by_path, photo_by_array = by_path_and_array(
        folded_pipeline, photo_path, photo, runs=JP2_TIMED)
    launches = {name: w.launches for name, w in wrappers.items()}
    by_array = golden_folded.recognize(scenes)
    for index, (path_result, array_result) in enumerate(zip(by_path, by_array)):
        if not same_words_and_boxes(path_result, array_result):
            raise AssertionError(f"scene {index} read by path gave other words or boxes than "
                                 f"its decoded array")
    if not same_words_and_boxes(photo_by_path[0], photo_by_array[0]):
        raise AssertionError("the JP2 photo read by path gave other words or boxes than its "
                             "decoded array")
    words = [[w for w, _ in result] for result in by_path]
    hits = sum(golden._word_match_fraction(entry["words"], found) * len(entry["words"])
               for entry, found in zip(expected, words))
    fraction = hits / max(sum(len(entry["words"]) for entry in expected), 1)
    if fraction < pass_fraction:
        raise AssertionError(f"golden scenes as lossy JP2: fraction {fraction} "
                             f"(pass >= {pass_fraction})")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the folded path was never launched: {launches}")
    print(f"jpeg2000, pipelines ({card}): the golden folded pipeline read the 12 lossy JP2 "
          f"scenes by path with the words and boxes of their decoded arrays, fraction "
          f"{fraction:.4f} (pass >= {pass_fraction}); the full-width folded pipeline's "
          f"recognize of the 640x480 JP2 photo by path equals that of its decoded array "
          f"({len(photo_by_path[0])} words; random weights): by path {path_s * 1e3:.1f} ms, "
          f"as its array {array_s * 1e3:.1f} ms (medians of {JP2_TIMED}, in turns), so the "
          f"read and decode take {(path_s - array_s) / path_s:.1%} of the call by path; "
          f"launches {launches}; phase 25 in {time.perf_counter() - phase_start:.1f} s")
    return launches


RASTER_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "rasters")
RASTER_DIR = os.path.join(ROOT, "build", "rasters")
RASTER_TIMED = 3


def rasters_phase(card, folded_pipeline, golden_folded, pass_fraction, wrappers):
    """Phase 26: every committed fixture of ``tests/fixtures/rasters``
    decoded by path to the sha256 of PIL's decode; the large files written
    here by ``scripts/make_raster_fixtures.py``'s numpy writers from the
    port's reads of their sources (each file's sha256 and its decode's
    checked against ``hashes.json``); host decode ms and MB/s of RGB out
    (median of 3) of scene 3 as raw PSD, PackBits PSD, QOI and RLE SGI and
    of a 640x480 PackBits PSD; the golden folded pipeline's ``recognize``
    of the 12 scenes as PackBits PSD and as QOI by path, words and boxes
    equal to those of their decoded arrays and ``pass_fraction`` reached;
    the 640x480 PSD read by the full-width folded pipeline by path and as
    its decoded array in turns (median of 3 each, words and boxes equal).
    Returns the launches of the kernels in the phase's pipeline runs,
    counted from zero."""
    from keras_ocr_tpu_torch import rasters, tools
    from keras_ocr_tpu_torch.utils import golden

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import make_raster_fixtures

    phase_start = time.perf_counter()
    with open(os.path.join(RASTER_FIXTURES, "hashes.json"), encoding="utf8") as f:
        hashes = json.load(f)
    shutil.rmtree(RASTER_DIR, ignore_errors=True)
    start = time.perf_counter()
    paths = make_raster_fixtures.write_large(RASTER_DIR, read=tools.read)
    write_s = time.perf_counter() - start
    committed = 0
    for name, expected in sorted(hashes.items()):
        path = paths.get(name, os.path.join(RASTER_FIXTURES, name))
        if expected.get("written_at_run_time"):
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != expected["file_sha256"]:
                raise AssertionError(f"{name}: the writers made other bytes here (sha256 "
                                     f"{digest}, the script's {expected['file_sha256']})")
        else:
            committed += 1
        image = tools.read(path)
        digest = hashlib.sha256(image.tobytes()).hexdigest()
        if list(image.shape) != expected["shape"] or digest != expected["decoded_sha256"]:
            raise AssertionError(f"{name}: decoded {image.shape} sha256 {digest}, PIL's "
                                 f"{expected['shape']} {expected['decoded_sha256']}")
    timed = {}
    for label, name, decode in (
            ("scene 3 as raw PSD", "scene_03_raw.psd", rasters.decode_psd),
            ("scene 3 as PackBits PSD", "scene_03.psd", rasters.decode_psd),
            ("scene 3 as QOI", "scene_03.qoi", rasters.decode_qoi),
            ("scene 3 as RLE SGI", "scene_03_rle.sgi", rasters.decode_sgi),
            ("the 640x480 photo as PackBits PSD", "photo_640x480.psd", rasters.decode_psd)):
        with open(paths[name], "rb") as f:
            blob = f.read()
        seconds, out = median_seconds(lambda b=blob, d=decode: d(b), runs=RASTER_TIMED)
        timed[label] = (seconds, out.nbytes, len(blob))
    print(f"rasters ({card}): {committed} committed fixtures (PSD, QOI, SGI, Sun, DIB, DCX, "
          f"ICNS, IM, MSP, XBM, XPM) and {len(paths)} files written here in "
          f"{write_s * 1e3:.0f} ms (the golden scenes as PackBits PSD and QOI, scene 3 raw "
          f"and as RLE SGI, the 640x480 photo) decoded by path to the sha256 of PIL's decode; "
          f"host decode (median of {RASTER_TIMED}, host CPU {host_cpu()}): " + "; ".join(
              f"{label} ({size} bytes) {seconds * 1e3:.2f} ms = "
              f"{nbytes / 1e6 / seconds:.2f} MB/s of RGB out"
              for label, (seconds, nbytes, size) in timed.items()))

    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        expected = json.load(f)["scenes"]
    kinds = {"PackBits PSD": ".psd", "QOI": ".qoi"}
    scene_paths = {kind: [paths[entry["image"].replace(".png", suffix)] for entry in expected]
                   for kind, suffix in kinds.items()}
    photo_path = paths["photo_640x480.psd"]
    photo = tools.read(photo_path)
    for wrapper in wrappers.values():
        wrapper.launches = 0
    by_path = {kind: golden_folded.recognize(ps) for kind, ps in scene_paths.items()}
    folded_pipeline.recognize([photo])
    path_s, array_s, photo_by_path, photo_by_array = by_path_and_array(
        folded_pipeline, photo_path, photo, runs=RASTER_TIMED)
    launches = {name: w.launches for name, w in wrappers.items()}
    fractions = {}
    for kind, ps in scene_paths.items():
        by_array = golden_folded.recognize([tools.read(p) for p in ps])
        for index, (path_result, array_result) in enumerate(zip(by_path[kind], by_array)):
            if not same_words_and_boxes(path_result, array_result):
                raise AssertionError(f"scene {index} as {kind} read by path gave other words "
                                     "or boxes than its decoded array")
        words = [[w for w, _ in result] for result in by_path[kind]]
        hits = sum(golden._word_match_fraction(entry["words"], found) * len(entry["words"])
                   for entry, found in zip(expected, words))
        fractions[kind] = hits / max(sum(len(entry["words"]) for entry in expected), 1)
        if fractions[kind] < pass_fraction:
            raise AssertionError(f"golden scenes as {kind}: fraction {fractions[kind]} (pass "
                                 f">= {pass_fraction})")
    if not same_words_and_boxes(photo_by_path[0], photo_by_array[0]):
        raise AssertionError("the 640x480 PSD read by path gave other words or boxes than its "
                             "decoded array")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the folded path was never launched: {launches}")
    shutil.rmtree(RASTER_DIR, ignore_errors=True)
    print(f"rasters, pipelines ({card}): the golden folded pipeline read the 12 scenes by path "
          f"with the words and boxes of their decoded arrays, fraction "
          + ", ".join(f"{fractions[kind]:.4f} as {kind}" for kind in kinds)
          + f" (pass >= {pass_fraction}); the full-width folded pipeline's recognize of the "
          f"640x480 PackBits PSD by path equals that of its decoded array "
          f"({len(photo_by_path[0])} words; random weights): by path {path_s * 1e3:.1f} ms, "
          f"as its array {array_s * 1e3:.1f} ms (medians of {RASTER_TIMED}, in turns), so the "
          f"read and decode take {(path_s - array_s) / path_s:.1%} of the call by path; "
          f"launches {launches}; phase 26 in {time.perf_counter() - phase_start:.1f} s")
    return launches


AVIF_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "avif")
AVIF_TIMED = 3


def avif_phase(card, folded_pipeline, golden_folded, pass_fraction, wrappers, lossy=False):
    """Phase 27, or 28 with ``lossy``: every lossless (lossy) fixture of
    ``tests/fixtures/avif`` decoded by path to the sha256 of PIL's decode,
    and each of them the port refuses raising ``NotImplementedError`` with
    the kind ``hashes.json`` names; host decode ms and MB/s of RGB out
    (median of 3) of scene 3 at 4:2:0 and 4:4:4 (lossy: at PIL's default
    quality, and the 640x480 photo); the golden folded pipeline's
    ``recognize`` of the 12 golden scenes as AVIF (lossless: at 4:2:0 in
    2x2 tiles; lossy: at PIL's default quality) by path, words and boxes
    equal to those of their decoded arrays and ``pass_fraction`` reached;
    one image's AVIF (scene 3; lossy: the 640x480 photo) read by the
    full-width folded pipeline by path and as its decoded array in turns
    (median of 3 each, words and boxes equal), the difference the read's
    share of the call by path. Returns the launches of the kernels in the
    phase's pipeline runs, counted from zero."""
    from keras_ocr_tpu_torch import avif, tools
    from keras_ocr_tpu_torch.utils import golden

    if lossy:
        phase, label, scene_suffix = 28, "lossy avif", "_q75.avif"
        timed_files = (("scene 3 at 4:2:0", "scene_03_q75.avif"),
                       ("scene 3 at 4:4:4", "lossy_scene_03_q75_444.avif"),
                       ("photo 640x480 at 4:2:0", "photo_640x480_q75.avif"))
        one, one_name = "the 640x480 photo", "photo_640x480_q75.avif"
        kinds = ("PIL's writer at qualities 97 to 5, every subsampling, aom speeds 2-10, all 19 "
                 "intra transform sizes, deblocking, CDEF, palette, tiles, 128x128 "
                 "superblocks, alpha, the 12 golden scenes and the 640x480 photo at quality 75")
    else:
        phase, label, scene_suffix = 27, "avif", ".avif"
        timed_files = (("scene 3 at 4:2:0", "scene_03.avif"),
                       ("scene 3 at 4:4:4", "scene_03_444.avif"))
        one, one_name = "scene 3", "scene_03.avif"
        kinds = ("lossless AV1: every subsampling and range, aom speeds 0-10, palette, CFL, "
                 "filter intra, 128x128 superblocks, tiles, alpha, irot / imir, avis, five "
                 "nclx matrices, iloc 0-2")
    phase_start = time.perf_counter()
    with open(os.path.join(AVIF_FIXTURES, "hashes.json"), encoding="utf8") as f:
        hashes = json.load(f)
    decoded, refused = {}, 0
    for name, expected in sorted(hashes.items()):
        if bool(expected.get("lossy")) != lossy:
            continue
        path = os.path.join(AVIF_FIXTURES, name)
        if expected.get("refused"):
            try:
                tools.read(path)
            except NotImplementedError as exc:
                if expected["refused"] not in str(exc):
                    raise AssertionError(f"{name}: refused as {exc!r}, not as "
                                         f"{expected['refused']}") from exc
                refused += 1
                continue
            raise AssertionError(f"{name}: read, where the port refuses {expected['refused']}")
        image = tools.read(path)
        digest = hashlib.sha256(image.tobytes()).hexdigest()
        if list(image.shape) != expected["shape"] or digest != expected["decoded_sha256"]:
            raise AssertionError(f"{name}: decoded {image.shape} sha256 {digest}, PIL's "
                                 f"{expected['shape']} {expected['decoded_sha256']}")
        decoded[name] = image
    decode_s = time.perf_counter() - phase_start
    timed = {}
    for timed_label, name in timed_files:
        with open(os.path.join(AVIF_FIXTURES, name), "rb") as f:
            blob = f.read()
        seconds, out = median_seconds(lambda b=blob: avif.decode_avif(b), runs=AVIF_TIMED)
        timed[timed_label] = (seconds, out.nbytes, len(blob))
    print(f"{label} ({card}): {len(decoded)} fixtures ({kinds}) decoded by path to the sha256 of "
          f"PIL's decode in {decode_s:.1f} s, {refused} refused by kind; host decode (median "
          f"of {AVIF_TIMED}, host CPU {host_cpu()}): " + "; ".join(
              f"{timed_label} ({size} bytes) {seconds * 1e3:.1f} ms = "
              f"{nbytes / 1e6 / seconds:.3f} MB/s of RGB out"
              for timed_label, (seconds, nbytes, size) in timed.items()))

    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        expected = json.load(f)["scenes"]
    names = [entry["image"].replace(".png", scene_suffix) for entry in expected]
    paths = [os.path.join(AVIF_FIXTURES, name) for name in names]
    one_path = os.path.join(AVIF_FIXTURES, one_name)
    image = decoded[one_name]
    for wrapper in wrappers.values():
        wrapper.launches = 0
    by_path = golden_folded.recognize(paths)
    folded_pipeline.recognize([image])
    path_s, array_s, one_by_path, one_by_array = by_path_and_array(
        folded_pipeline, one_path, image, runs=AVIF_TIMED)
    launches = {name: w.launches for name, w in wrappers.items()}
    by_array = golden_folded.recognize([decoded[name] for name in names])
    for index, (path_result, array_result) in enumerate(zip(by_path, by_array)):
        if not same_words_and_boxes(path_result, array_result):
            raise AssertionError(f"{label}: scene {index} read by path gave other words or boxes "
                                 f"than its decoded array")
    if not same_words_and_boxes(one_by_path[0], one_by_array[0]):
        raise AssertionError(f"{label}: {one} read by path through the full-width pipeline gave "
                             f"other words or boxes than its decoded array")
    words = [[w for w, _ in result] for result in by_path]
    hits = sum(golden._word_match_fraction(entry["words"], found) * len(entry["words"])
               for entry, found in zip(expected, words))
    fraction = hits / max(sum(len(entry["words"]) for entry in expected), 1)
    if fraction < pass_fraction:
        raise AssertionError(f"golden scenes as {label}: fraction {fraction} "
                             f"(pass >= {pass_fraction})")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the folded path was never launched: {launches}")
    print(f"{label}, pipelines ({card}): the golden folded pipeline read the 12 AVIF scenes "
          f"({names[0]}, ...) by path with the words and boxes of their decoded arrays, "
          f"fraction {fraction:.4f} (pass >= {pass_fraction}); the full-width folded "
          f"pipeline's recognize of {one}'s AVIF by path equals that of its decoded array "
          f"({len(one_by_path[0])} words; random weights): by path {path_s * 1e3:.1f} ms, as "
          f"its array {array_s * 1e3:.1f} ms (medians of {AVIF_TIMED}, in turns), so the read "
          f"and decode take {(path_s - array_s) / path_s:.1%} of the call by path; launches "
          f"{launches}; phase {phase} in {time.perf_counter() - phase_start:.1f} s")
    return launches


# Phase 21: both trainers on a mesh across two processes of the one card.
DIST_DIR = os.path.join(ROOT, "build", "distributed")
DIST_WORLD = 2
DIST_STEPS = 3
DIST_CRNN_BATCH = 8
DIST_CRAFT = (4, 640, 640)
DIST_LOSS_BAR = 1e-4
DIST_PARAM_BAR = 1e-4
DIST_TIMEOUT = 240.0


def distributed_steps(mesh, dtype, state, device):
    """DIST_STEPS steps of each trainer from ``state`` on ``mesh``: per
    model (losses, step ms, the variable tree after the steps)."""
    from keras_ocr_tpu_torch import Detector, Recognizer, weights
    from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer

    rng = np.random.RandomState(21)
    crnn = [crnn_batch(rng, DIST_CRNN_BATCH, 48, 36) for _ in range(DIST_STEPS)]
    craft = [craft_batch(rng, *DIST_CRAFT) for _ in range(DIST_STEPS)]
    out = {}
    for label, make, trainer_cls, bridge, batches in (
            ("crnn", lambda: Recognizer(weights=None, device=device, compute_dtype=dtype),
             RecognizerTrainer, weights.crnn_variables, crnn),
            ("craft", lambda: Detector(weights=None, width=1.0, device=device,
                                       compute_dtype=dtype),
             DetectorTrainer, weights.craft_variables, craft)):
        facade = make()
        facade.model.load_state_dict(state[label])
        trainer = trainer_cls(facade, mesh=mesh)
        losses, step_ms = [], []
        for batch in batches:
            torch.cuda.synchronize()
            start = time.perf_counter()
            losses.append(trainer.train_step(batch))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - start) * 1e3)
        out[label] = losses, step_ms, bridge(facade.model)
    return out


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` and deterministic cuDNN
    for the block, the process's settings restored after. The full-width
    CRNN's float32 step is not the same from run to run on an H100
    without them (PERF.md §6); cuBLAS's share needs the fixed
    workspace ``main`` sets before the first CUDA call."""
    saved = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]


def distributed_rank(rank, port):
    """One process of phase 21: a rank of the ``gloo`` group on cuda:0, on
    the hybrid mesh whose ``slice`` axis spans the processes, running both
    trainers' steps in float32 and bf16 under deterministic algorithms;
    rank 0 saves the float32 models' checkpoints. Results go to
    ``DIST_DIR/rank<r>.pt``, a failure's traceback to ``rank<r>.err``."""
    import datetime
    import traceback

    try:
        sys.path.insert(0, ROOT)
        from keras_ocr_tpu_torch import parallel
        from keras_ocr_tpu_torch.train import checkpoint

        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        parallel.initialize_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                                        rank=rank, world_size=DIST_WORLD,
                                        timeout=datetime.timedelta(seconds=DIST_TIMEOUT / 2))
        mesh = parallel.create_hybrid_mesh(DIST_WORLD, (1, 1), devices=[device])
        state = torch.load(os.path.join(DIST_DIR, "state.pt"), map_location=device)
        results = {"mesh": repr(mesh), "spans": mesh.spans_processes}
        with deterministic_algorithms():
            for dtype in (torch.float32, torch.bfloat16):
                steps = distributed_steps(mesh, dtype, state, device)
                results[str(dtype)] = steps
                if dtype == torch.float32:
                    for label, (_, _, tree) in steps.items():
                        checkpoint.save(os.path.join(DIST_DIR, f"{label}.npz"), tree)
        results["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.save(results, os.path.join(DIST_DIR, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(DIST_DIR, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target, world, timeout):
    """Start ``world`` processes of ``target(rank, port)`` (spawned), wait
    for all of them at most ``timeout`` seconds, and kill them all as soon
    as one fails or the time is up; raises naming the failed rank."""
    import socket
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    context = mp.get_context("spawn")
    procs = [context.Process(target=target, args=(rank, port), daemon=True)
             for rank in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"the {world} ranks did not finish in {timeout} s")
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        for proc in procs:
            proc.join(10)
    for rank, proc in enumerate(procs):
        if proc.exitcode != 0:
            error = os.path.join(DIST_DIR, f"rank{rank}.err")
            text = open(error).read() if os.path.exists(error) else "no traceback"
            raise AssertionError(f"rank {rank} exited with {proc.exitcode}:\n{text}")


def distributed_phase(card, scenes, wrappers):
    """Phase 21: two processes, one ``gloo`` group on the one card, each
    trainer on a mesh whose ``slice`` axis spans them, against the same
    steps on the one-process mesh of two replicas; then the checkpoint
    rank 0 wrote, folded, through the pipeline. Returns the kernels'
    launches in that pipeline's run."""
    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, parallel
    from keras_ocr_tpu_torch.models import craft as craft_module
    from keras_ocr_tpu_torch.ops import cc, cc_cuda, conv_cuda
    from keras_ocr_tpu_torch.train import checkpoint

    phase_start = time.perf_counter()
    device = torch.device("cuda", 0)
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    state = {"crnn": Recognizer(weights=None, device=device, seed=21).model.state_dict(),
             "craft": Detector(weights=None, width=1.0, device=device,
                               seed=22).model.state_dict()}
    torch.save(state, os.path.join(DIST_DIR, "state.pt"))
    gc.collect()
    torch.cuda.empty_cache()
    start = time.perf_counter()
    run_ranks(distributed_rank, DIST_WORLD, DIST_TIMEOUT)
    ranks_s = time.perf_counter() - start
    ranks = [torch.load(os.path.join(DIST_DIR, f"rank{r}.pt"), weights_only=False)
             for r in range(DIST_WORLD)]
    # The reference here: the same steps on the one-process mesh of the
    # same shape, two replicas of the card.
    one_process = parallel.create_hybrid_mesh(DIST_WORLD, (1, 1), devices=[device] * DIST_WORLD)
    if not ranks[0]["spans"] or one_process.spans_processes:
        raise AssertionError(f"meshes: {ranks[0]['mesh']}, {one_process}")
    start = time.perf_counter()
    with deterministic_algorithms():
        reference = {str(dtype): distributed_steps(one_process, dtype, state, device)
                     for dtype in (torch.float32, torch.bfloat16)}
    reference_s = time.perf_counter() - start
    lines = []
    for dtype, steps in reference.items():
        for label, (ref_losses, ref_ms, ref_tree) in steps.items():
            losses, step_ms, tree = ranks[0][dtype][label]
            ours, ref_leaves = dict(tree_leaves(tree)), dict(tree_leaves(ref_tree))
            for other in ranks[1:]:
                other_losses, _, other_tree = other[dtype][label]
                theirs = dict(tree_leaves(other_tree))
                if other_losses != losses or any(not np.array_equal(theirs[k], v)
                                                 for k, v in ours.items()):
                    raise AssertionError(f"{dtype} {label}: the ranks' losses or parameters "
                                         "differ")
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            errors = {k: float(np.abs(ours[k].astype(np.float64) - v).max())
                      / max(1.0, float(np.abs(v).max())) for k, v in ref_leaves.items()}
            worst = max(errors, key=errors.get)
            if not (loss_err <= DIST_LOSS_BAR and errors[worst] <= DIST_PARAM_BAR):
                raise AssertionError(f"{dtype} {label} across processes: losses {losses} vs "
                                     f"{ref_losses} ({loss_err:.3e} relative), worst leaf "
                                     f"{worst} {errors[worst]:.3e}")
            lines.append(f"{dtype.replace('torch.', '')} {label}: losses "
                         f"{', '.join(f'{x:.6f}' for x in losses)} within {loss_err:.2e} "
                         f"relative, parameters within {errors[worst]:.2e} ({worst}); step ms "
                         f"two processes {', '.join(f'{x:.1f}' for x in step_ms)} vs one "
                         f"process {', '.join(f'{x:.1f}' for x in ref_ms)}")
    print(f"distributed ({card}): {DIST_WORLD} processes (gloo, both on cuda:0, "
          f"{ranks[0]['mesh']}), {DIST_STEPS} steps each of the full-width CRNN (batch "
          f"{DIST_CRNN_BATCH}) and the VGG CRAFT ({'x'.join(map(str, DIST_CRAFT))}) against "
          f"the one-process mesh of two replicas (bars "
          f"{DIST_LOSS_BAR} / {DIST_PARAM_BAR}), all under deterministic algorithms, the "
          f"ranks' parameters bit for bit equal: " + "; ".join(lines)
          + f"; wall {ranks_s:.1f} s for the ranks (start-up included), {reference_s:.1f} s "
          f"for the reference, peak {max(r['peak_gb'] for r in ranks):.2f} GB a rank")

    # The checkpoints rank 0 wrote: the CRAFT folded on load, with the CRNN,
    # through the pipeline on the golden scenes, each kernel call checked.
    folded = Detector(weights=None, width=1.0, fold_bn=True, device=device).load_variables(
        checkpoint.restore(os.path.join(DIST_DIR, "craft.npz")))
    recognizer = Recognizer(weights=None, device=device).load_variables(
        checkpoint.restore(os.path.join(DIST_DIR, "crnn.npz")))
    pipeline = Pipeline(folded, recognizer, scale=2)
    for wrapper in wrappers.values():
        wrapper.launches = 0
    sweep_calls, conv_calls = [], []
    undo = checked_sweeps(cc, cc_cuda, sweep_calls)
    craft_module.conv_cuda = CheckedConvs(conv_cuda, conv_calls, what="distributed folded chain")
    try:
        results = pipeline.recognize(scenes[:4])
    finally:
        craft_module.conv_cuda = conv_cuda
        undo()
    check_results(results, 4)
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the pipeline of the distributed checkpoint launched {launches}")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    print(f"distributed ({card}): rank 0's checkpoints restored here, the CRAFT folded on "
          f"load: Pipeline.recognize of 4 golden scenes, {sum(len(r) for r in results)} "
          f"words; {len(conv_calls)} conv_chain calls within {CONV_BAR} of the plain chain, "
          f"{len(sweep_calls)} sweep calls equal to their plain versions; launches {launches}; "
          f"phase 21 in {time.perf_counter() - phase_start:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path", file=sys.stderr)
        return 1
    # cuBLAS's workspace fixed at the H100's default size (32 MiB, what
    # PyTorch takes on sm_90), so that phase 21 can turn deterministic
    # algorithms on in this process and in the ones it spawns.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    started = time.perf_counter()
    laps, lap_start = {}, [started]

    def lap(name):
        """Seconds since the previous lap, kept under ``name``."""
        now = time.perf_counter()
        laps[name] = now - lap_start[0]
        lap_start[0] = now

    sys.path.insert(0, ROOT)
    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, kernels, tools
    from keras_ocr_tpu_torch.models.craft import fold_bn_state_dict
    from keras_ocr_tpu_torch.ops import cc_cuda, conv_cuda
    from keras_ocr_tpu_torch.utils import golden

    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(f"environment: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    def build(source):
        start = time.perf_counter()
        kernels.load(source)
        return time.perf_counter() - start

    # Both sources build at once; the sweep kernel's phase and the golden
    # pipeline's traffic need only cc_sweeps.cu and run while
    # conv_chain.cu still builds.
    sources = (cc_cuda.SOURCE, conv_cuda.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = [pool.submit(build, source) for source in sources]
        cc_build_s = builds[0].result()
        report = kernel_phase(cc_cuda)
        with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
            golden_scenes = json.load(f)["scenes"]
        names = [entry["image"] for entry in golden_scenes]
        golden_images = [tools.read(os.path.join(ARTIFACT, name)) for name in names]
        golden_pipeline = golden.load_golden_pipeline(ARTIFACT, device=device)[0]
        golden_traffic(cc_cuda, golden_pipeline, golden_images[:8])
        waited = time.perf_counter()
        conv_build_s = builds[1].result()
        waited = time.perf_counter() - waited
    print(f"build: {sources[0]} in {cc_build_s:.2f} s, {sources[1]} in {conv_build_s:.2f} s "
          f"(started together; the sweep kernel's phase ran meanwhile, then waited "
          f"{waited:.2f} s for {sources[1]})")
    lap("build, 1-2")
    report.update(conv_phase(conv_cuda))
    # Phase 15's kernel part, here so that its profiler sessions come
    # first in the process.
    bf16_kernel_report = bf16_kernels(card, conv_cuda, report["conv_chain"]["per_chain"])
    lap("3, 15's kernels")
    sweep_wrappers = {
        "cc_sweeps": cc_cuda.segmented_min_sweeps,
        "cc_keyed_rows_cols": cc_cuda.keyed_rows_cols,
    }
    conv_wrappers = {
        "conv_chain": conv_cuda.conv_chain,
        "conv3x3_bias_act": conv_cuda.conv3x3_bias_act,
    }
    all_wrappers = {**sweep_wrappers, **conv_wrappers}
    with open(os.path.join(ARTIFACT, "meta.json"), encoding="utf8") as f:
        pass_fraction = json.load(f)["pass_fraction"]

    def golden_phase(label, pipeline):
        result = golden.run_golden_check(ARTIFACT, pipeline=pipeline)
        print(f"{label}: fraction {result['fraction']} over {result['n_words']} words / "
              f"{result['n_scenes']} scenes (pass >= {pass_fraction}); last_run_stats "
              f"{result['run_stats']}")
        if not result["pass"]:
            raise AssertionError(f"{label} check failed: {result}")
        return result

    # The default path (BatchNorm unfolded, cuDNN): count its launches.
    for wrapper in all_wrappers.values():
        wrapper.launches = 0
    fp32_golden = {False: golden_phase("golden", golden_pipeline)}
    detector = Detector(weights=None, width=1.0, device=device, seed=0)
    recognizer = Recognizer(weights=None, device=device, seed=1)
    pipeline = Pipeline(detector=detector, recognizer=recognizer, scale=2)
    scenes = [tools.pad(image, width=640, height=480) for image in golden_images]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        check_results(pipeline.recognize([scenes[0]]), 1)
    # The device program must not make the host wait: only the fetch does.
    enqueue_without_sync(pipeline, scenes[:8])
    p50, images_per_s = time_pipeline(pipeline, scenes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: wrapper.launches for name, wrapper in sweep_wrappers.items()}
    print(f"full width ({card}): device program of 8 images enqueued with no host "
          f"synchronisation (torch.cuda sync debug mode 'error'); recognize p50 "
          f"{p50:.2f} ms (640x480, scale 2, 10 images), recognize_many {images_per_s:.2f} images/s "
          f"(32 images, batch 8), peak memory {peak_gb:.3f} GB; last_run_stats "
          f"{pipeline.last_run_stats}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")

    # The folded path (BatchNorm folded, the conv kernel): count its launches.
    for wrapper in all_wrappers.values():
        wrapper.launches = 0
    golden_folded = golden.load_golden_pipeline(ARTIFACT, device=device, fold_bn=True)[0]
    fp32_golden[True] = golden_phase("golden, folded", golden_folded)
    golden_launches = {name: w.launches for name, w in conv_wrappers.items()}
    if min(golden_launches.values()) <= 0:
        raise AssertionError(f"the folded golden path skipped a conv kernel: {golden_launches}")
    seed_batch_norm(detector.model, seed=2)
    folded = Detector(weights=None, width=1.0, fold_bn=True, device=device)
    folded.model.load_state_dict(fold_bn_state_dict(detector.model.state_dict()))
    folded_pipeline = Pipeline(detector=folded, recognizer=recognizer, scale=2)
    with torch.inference_mode():
        x = craft_input(pipeline, scenes[:2])
        ref = detector.model(x)
        err = check_close("folded heatmaps", folded.model(x), ref, HEATMAP_BAR)
    print(f"full width, folded: heatmaps of 2 scenes (960x1280 input) within {err:.3e} "
          f"of the unfolded cuDNN graph (max|ref| {float(ref.abs().max()):.3e}; bar "
          f"{HEATMAP_BAR} * max(1, max|ref|))")
    enqueue_without_sync(folded_pipeline, scenes[:8])
    times = {}
    for label, pipe in (("unfolded", pipeline), ("folded", folded_pipeline)):
        check_results(pipe.recognize([scenes[0]]), 1)
        times[label] = time_pipeline(pipe, scenes)
    launches.update({name: w.launches for name, w in conv_wrappers.items()})
    print(f"full width, folded ({card}): device program of 8 images enqueued with no "
          f"host synchronisation; recognize p50 {times['folded'][0]:.2f} ms folded vs "
          f"{times['unfolded'][0]:.2f} ms unfolded, recognize_many "
          f"{times['folded'][1]:.2f} vs {times['unfolded'][1]:.2f} images/s (seeded BN "
          f"statistics); launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")

    forward_ms = {}
    with torch.inference_mode():
        for batch, runs in ((1, 20), (8, 5)):
            x = torch.randn((batch, 960, 1280, 3), generator=torch.Generator(
                device="cuda").manual_seed(batch), device="cuda")
            for label, model in (("unfolded", detector.model), ("folded", folded.model)):
                forward_ms[label, batch] = cuda_median_ms(lambda: model(x), runs=runs)
    print(f"CRAFT forward ({card}), 960x1280: batch 1 unfolded (cuDNN) "
          f"{forward_ms['unfolded', 1]:.3f} ms, folded (conv kernel) "
          f"{forward_ms['folded', 1]:.3f} ms; batch 8 {forward_ms['unfolded', 8]:.3f} ms "
          f"vs {forward_ms['folded', 8]:.3f} ms (median of 20 / 5)")

    lap("4-7")
    refine_phase(card, detector, recognizer, scenes)
    lap("8")

    expected = [entry["words"] for entry in golden_scenes]
    two_stage_phase(card, golden_images, expected,
                    (("golden", golden_pipeline), ("golden, folded", golden_folded)),
                    all_wrappers, pass_fraction, pipeline, p50)
    lap("9")

    serving_phase(card, golden_images, expected,
                  (("golden", golden_pipeline), ("golden, folded", golden_folded)),
                  all_wrappers, pass_fraction, pipeline, scenes)
    lap("10")

    float32_steps = training_phase(card, golden_images, sweep_wrappers)
    lap("11")

    weights_phase(card, scenes, sweep_wrappers, conv_wrappers)
    lap("12")

    for name, count in efficientnet_phase(card, scenes, detector, recognizer,
                                          sweep_wrappers).items():
        launches[name] += count
    lap("13")

    for name, count in data_phase(card, sweep_wrappers).items():
        launches[name] += count
    lap("14")

    fp32 = {"golden": fp32_golden, "times": times, "forward_ms": forward_ms,
            "detector": detector, "pipelines": {"standard": pipeline, "folded": folded_pipeline}}
    bf16_report, bf16_launches = bf16_phase(card, conv_cuda, fp32, scenes, pass_fraction,
                                            all_wrappers, bf16_kernel_report)
    report.update(bf16_report)
    launches.update(bf16_launches)
    lap("15")

    for name, count in mesh_phase(card, {"standard": pipeline, "folded": folded_pipeline},
                                  scenes, all_wrappers).items():
        launches[name] += count
    lap("16")

    for name, count in bf16_training_phase(card, float32_steps, scenes, all_wrappers).items():
        launches[name] += count
    lap("17")

    for name, count in spatial_phase(card, detector, folded, recognizer, scenes,
                                     all_wrappers).items():
        launches[name] += count
    lap("18")

    for name, count in synthetic_phase(card, all_wrappers).items():
        launches[name] += count
    lap("19")

    codecs_phase(card)
    lap("20")

    for name, count in distributed_phase(card, scenes, all_wrappers).items():
        launches[name] += count
    lap("21")

    for name, count in image_formats_phase(card, folded_pipeline, golden_folded,
                                           golden_images, pass_fraction,
                                           all_wrappers).items():
        launches[name] += count
    lap("22")

    for name, count in webp_phase(card, golden_folded, pass_fraction, all_wrappers).items():
        launches[name] += count
    lap("23")

    for name, count in jpeg_modes_phase(card, golden_folded, golden_images, pass_fraction,
                                        all_wrappers).items():
        launches[name] += count
    lap("24")

    for name, count in jpeg2000_phase(card, folded_pipeline, golden_folded, pass_fraction,
                                      all_wrappers).items():
        launches[name] += count
    lap("25")

    for name, count in rasters_phase(card, folded_pipeline, golden_folded, pass_fraction,
                                     all_wrappers).items():
        launches[name] += count
    lap("26")

    for name, count in avif_phase(card, folded_pipeline, golden_folded, pass_fraction,
                                  all_wrappers).items():
        launches[name] += count
    lap("27")

    for name, count in avif_phase(card, folded_pipeline, golden_folded, pass_fraction,
                                  all_wrappers, lossy=True).items():
        launches[name] += count
    lap("28")

    replaces = {
        "cc_sweeps": "keras_ocr_tpu/ops/cc_pallas.py:82",
        # An XLA loop in the JAX package, not a Pallas kernel.
        "cc_keyed_rows_cols": "keras_ocr_tpu/ops/cc.py:210",
        "conv_chain": "keras_ocr_tpu/ops/conv_pallas.py:141",
        "conv3x3_bias_act": "keras_ocr_tpu/ops/conv_pallas.py:302",
        # The same TPU kernels on a bfloat16 input.
        "conv_chain_bf16": "keras_ocr_tpu/ops/conv_pallas.py:141",
        "conv3x3_bias_act_bf16": "keras_ocr_tpu/ops/conv_pallas.py:302",
    }
    sources = {
        "cc_sweeps": cc_cuda.SOURCE, "cc_keyed_rows_cols": cc_cuda.SOURCE,
        "conv_chain": conv_cuda.SOURCE, "conv3x3_bias_act": conv_cuda.SOURCE,
        "conv_chain_bf16": conv_cuda.SOURCE, "conv3x3_bias_act_bf16": conv_cuda.SOURCE,
    }
    print(f"chip_smoke: all phases in {time.perf_counter() - started:.1f} s; by phase: "
          + ", ".join(f"{name} {seconds:.1f}" for name, seconds in laps.items()))
    print(card)
    print(json.dumps({"kernels": [
        {
            "name": name,
            "op": f"keras_ocr_tpu_torch::{OPS[name]}",
            "route": "cuda",
            "source": f"keras_ocr_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name],
            "launches": launches[name],
            **{key: report[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        for name in (*all_wrappers, *bf16_launches)
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
