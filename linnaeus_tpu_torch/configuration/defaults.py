"""Default configuration tree.

Copy of linnaeus_tpu/configuration/defaults.py, key for key and value for
value, so an experiment or model yaml merges into the port's defaults as it
merges into the JAX package's (tests/test_torch_configuration.py compares
``get_default_config().to_dict()`` and every yaml under ``configs/``). The
comments describe each key as the JAX package reads it; the port reads the
``MODEL.*`` keys in ``models/build.py`` and says there which it does not
have yet. The upstream framework's surface is kept, with these additions:

* ``TRAIN.AMP_OPT_LEVEL`` ("O0".."O3") is kept for compatibility but the
  native control is ``TRAIN.MIXED_PRECISION`` (compute dtype, bf16 default).
* ``DATA.AUTOBATCH`` probes compiled memory rather than allocator statistics
  in the JAX package; the port runs ``STEPS_PER_TRIAL`` real steps a trial
  and reads the allocator's peak (train/autobatch.py).
* A ``PARALLEL`` section describes the device mesh.
"""

from .cfg_node import CfgNode as CN


def _build_default_config() -> CN:
    _C = CN()
    _C.BASE = [""]

    # ------------------------------------------------------------------ EXPERIMENT
    _C.EXPERIMENT = CN()
    _C.EXPERIMENT.NAME = ""
    _C.EXPERIMENT.PROJECT = ""
    _C.EXPERIMENT.GROUP = ""
    _C.EXPERIMENT.TAGS = []
    _C.EXPERIMENT.NOTES = ""
    _C.EXPERIMENT.CODE_VERSION = ""
    _C.EXPERIMENT.WANDB = CN()
    _C.EXPERIMENT.WANDB.ENABLED = False
    _C.EXPERIMENT.WANDB.RESUME = False
    _C.EXPERIMENT.WANDB.KEY = ""
    _C.EXPERIMENT.WANDB.RUN_ID = ""
    _C.EXPERIMENT.LOG_LEVEL_MAIN = "INFO"
    _C.EXPERIMENT.LOG_LEVEL_H5DATA = "INFO"
    _C.EXPERIMENT.LOG_LEVEL_VALIDATION = "INFO"

    # ------------------------------------------------------------------ METRICS
    _C.METRICS = CN()
    _C.METRICS.FROM = ""
    _C.METRICS.TAXA_SUBSETS = []
    _C.METRICS.RARITY_PERCENTILES = [1, 5, 25, 50, 75, 90, 95, 99]
    _C.METRICS.TRACK_RARITY = False
    _C.METRICS.TRACK_NULL_VS_NON_NULL = False
    _C.METRICS.NULL_VS_NON_NULL_TASKS = ["taxa_L10"]
    # -- inert compatibility stubs so reference YAMLs merge unchanged --
    # (all DEPRECATED in the reference config.py:112-141,524,915 or
    # site/hardware-specific; read by nothing here)
    _C.METRICS.USE_GPU = True
    _C.METRICS.DEBUG_COMPARE = False
    _C.METRICS.TAXALIGN = CN()
    _C.METRICS.TAXALIGN.ENABLED = False
    _C.METRICS.TAXALIGN.COMPUTE_INTERVAL = 10
    _C.CHECKPOINT = CN()
    _C.CHECKPOINT.KEEP_TOP_N = 0
    _C.CHECKPOINT.KEEP_LAST_N = 0
    _C.CHECKPOINT.SAVE_FREQ = 0

    # ------------------------------------------------------------------ ENV
    _C.ENV = CN()
    _C.ENV.FROM = ""
    _C.ENV.INPUT = CN()
    _C.ENV.INPUT.BASE_DIR = "/data"
    _C.ENV.INPUT.CACHE_DIR = ""
    _C.ENV.INPUT.BUCKET = CN()
    _C.ENV.INPUT.BUCKET.REMOTE = ""
    _C.ENV.INPUT.BUCKET.BUCKET = ""
    _C.ENV.INPUT.BUCKET.APP_KEY_ID = ""
    _C.ENV.INPUT.BUCKET.APP_KEY = ""
    _C.ENV.INPUT.BUCKET.ENABLED = False
    _C.ENV.OUTPUT = CN()
    _C.ENV.OUTPUT.BASE_DIR = "/outputs"
    _C.ENV.OUTPUT.BUCKET = CN()
    _C.ENV.OUTPUT.BUCKET.REMOTE = ""
    _C.ENV.OUTPUT.BUCKET.BUCKET = ""
    _C.ENV.OUTPUT.BUCKET.APP_KEY_ID = ""
    _C.ENV.OUTPUT.BUCKET.APP_KEY = ""
    _C.ENV.OUTPUT.BUCKET.ENABLED = False
    # also sync after every checkpoint save (end-of-training sync is implied
    # by ENABLED; reference syncs once from main.py)
    _C.ENV.OUTPUT.BUCKET.SYNC_ON_CHECKPOINT = False
    _C.ENV.OUTPUT.DIRS = CN()
    _C.ENV.OUTPUT.DIRS.EXP_BASE = ""
    _C.ENV.OUTPUT.DIRS.CHECKPOINTS = ""
    _C.ENV.OUTPUT.DIRS.METADATA = ""
    _C.ENV.OUTPUT.DIRS.LOGS = ""
    _C.ENV.OUTPUT.DIRS.ASSETS = ""
    _C.ENV.OUTPUT.DIRS.CONFIGS = ""
    # compat stubs: TACC/SLURM site specifics (reference config.py:151-152)
    _C.ENV.TACC = False
    _C.ENV.SCRATCH = None
    # Persistent XLA compilation cache (TPU-native addition; no reference
    # analog). Restarting after preemption otherwise repays the full
    # multi-minute compile of the train/eval steps. DIR='' -> a default
    # under ~/.cache; set ENABLED=False to opt out.
    _C.ENV.COMPILE_CACHE = CN()
    _C.ENV.COMPILE_CACHE.ENABLED = True
    _C.ENV.COMPILE_CACHE.DIR = ""
    _C.ENV.COMPILE_CACHE.MIN_COMPILE_SECS = 1.0

    # ------------------------------------------------------------------ DATA
    _C.DATA = CN()
    _C.DATA.FROM = ""
    # parity no-op: the vectorized processor is the ONLY implementation
    # here (data/processor.py); the reference's per-sample fallback was
    # not carried over
    _C.DATA.USE_VECTORIZED_PROCESSOR = True
    _C.DATA.BATCH_SIZE = 64  # global per-host train batch size
    _C.DATA.BATCH_SIZE_VAL = 128
    _C.DATA.IMG_SIZE = 384
    _C.DATA.PIN_MEMORY = True  # kept for config parity; no-op on TPU hosts
    _C.DATA.NUM_WORKERS = 8  # host-side IO/preprocess threads

    _C.DATA.SAMPLER = CN()
    _C.DATA.SAMPLER.TYPE = "grouped"  # 'grouped' or 'standard'
    _C.DATA.SAMPLER.GROUPED_MODE = "strict-group"  # or 'mixed-pairs'

    _C.DATA.SIMULATE_HPC = False
    _C.DATA.IO_DELAY = 0.0

    _C.DATA.AUTOBATCH = CN()
    _C.DATA.AUTOBATCH.ENABLED = False
    _C.DATA.AUTOBATCH.TARGET_MEMORY_FRACTION = 0.8
    _C.DATA.AUTOBATCH.MAX_BATCH_SIZE = 512
    _C.DATA.AUTOBATCH.MIN_BATCH_SIZE = 1
    # STEPS_PER_TRIAL: steps a trial runs in the port (train/autobatch.py);
    # a no-op in the JAX package, which reads compiled memory. LOG_LEVEL is
    # a parity no-op
    _C.DATA.AUTOBATCH.STEPS_PER_TRIAL = 2
    _C.DATA.AUTOBATCH.LOG_LEVEL = "INFO"
    _C.DATA.AUTOBATCH.ENABLED_VAL = False
    _C.DATA.AUTOBATCH.TARGET_MEMORY_FRACTION_VAL = 0.8
    _C.DATA.AUTOBATCH.MAX_BATCH_SIZE_VAL = 1024
    _C.DATA.AUTOBATCH.MIN_BATCH_SIZE_VAL = 1
    _C.DATA.AUTOBATCH.STEPS_PER_TRIAL_VAL = 2
    _C.DATA.AUTOBATCH.LOG_LEVEL_VAL = "INFO"

    # dataset identity strings: recorded into run config/wandb only
    _C.DATA.DATASET = CN()
    _C.DATA.DATASET.NAME = ""
    _C.DATA.DATASET.VERSION = ""
    _C.DATA.DATASET.CLADE = ""

    _C.DATA.TASK_KEYS_H5 = ["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"]

    _C.DATA.PARTIAL = CN()
    _C.DATA.PARTIAL.LEVELS = False

    _C.DATA.OUT_OF_REGION = CN()
    _C.DATA.OUT_OF_REGION.INCLUDE = True

    _C.DATA.UPWARD_MAJOR_CHECK = False

    _C.DATA.META = CN(new_allowed=True)
    _C.DATA.META.ACTIVE = True
    _C.DATA.META.COMPONENTS = CN(new_allowed=True)
    _C.DATA.META.COMPONENTS.TEMPORAL = CN()
    _C.DATA.META.COMPONENTS.TEMPORAL.ENABLED = True
    _C.DATA.META.COMPONENTS.TEMPORAL.SOURCE = "temporal"
    _C.DATA.META.COMPONENTS.TEMPORAL.COLUMNS = []
    _C.DATA.META.COMPONENTS.TEMPORAL.DIM = 2
    _C.DATA.META.COMPONENTS.TEMPORAL.IDX = 0
    _C.DATA.META.COMPONENTS.TEMPORAL.ALLOW_MISSING = True
    _C.DATA.META.COMPONENTS.TEMPORAL.OOR_MASK = False
    _C.DATA.META.COMPONENTS.SPATIAL = CN()
    _C.DATA.META.COMPONENTS.SPATIAL.ENABLED = True
    _C.DATA.META.COMPONENTS.SPATIAL.SOURCE = "spatial"
    _C.DATA.META.COMPONENTS.SPATIAL.COLUMNS = []
    _C.DATA.META.COMPONENTS.SPATIAL.DIM = 3
    _C.DATA.META.COMPONENTS.SPATIAL.IDX = 1
    _C.DATA.META.COMPONENTS.SPATIAL.ALLOW_MISSING = True
    _C.DATA.META.COMPONENTS.SPATIAL.OOR_MASK = False
    _C.DATA.META.COMPONENTS.ELEVATION = CN()
    _C.DATA.META.COMPONENTS.ELEVATION.ENABLED = False
    _C.DATA.META.COMPONENTS.ELEVATION.SOURCE = "elevation_broadrange_2"
    _C.DATA.META.COMPONENTS.ELEVATION.COLUMNS = []
    _C.DATA.META.COMPONENTS.ELEVATION.DIM = 10
    _C.DATA.META.COMPONENTS.ELEVATION.IDX = 2
    _C.DATA.META.COMPONENTS.ELEVATION.ALLOW_MISSING = True
    _C.DATA.META.COMPONENTS.ELEVATION.OOR_MASK = False

    _C.DATA.H5 = CN()
    _C.DATA.H5.TRAIN_LABELS_PATH = None
    _C.DATA.H5.VAL_LABELS_PATH = None
    _C.DATA.H5.LABELS_PATH = None
    _C.DATA.H5.TRAIN_IMAGES_PATH = None
    _C.DATA.H5.VAL_IMAGES_PATH = None
    _C.DATA.H5.IMAGES_PATH = None
    _C.DATA.H5.TRAIN_VAL_SPLIT_RATIO = 0.9
    _C.DATA.H5.TRAIN_VAL_SPLIT_SEED = 42
    # 'auto': batch image reads bypass HDF5 selection machinery via
    # chunk-offset preadv when the dataset is one-row-per-chunk filterless
    # uint8 at target size (measured 4.7x per-row h5py reads on one core);
    # 'off' forces per-row reads; 'on' raises when the layout is ineligible
    _C.DATA.H5.DIRECT_CHUNK_READS = "auto"

    # C++ batch data-plane for hybrid (images-on-disk) reads: file IO + JPEG
    # decode (DCT prescale) + area resize in native worker threads, one
    # Python call per batch (linnaeus_tpu/native/). 'auto' uses it when it
    # compiles and files are JPEG; 'off' forces the cv2/PIL per-sample path;
    # 'on' raises if the native library is unavailable.
    _C.DATA.NATIVE_DATAPLANE = "auto"

    _C.DATA.HYBRID = CN()
    _C.DATA.HYBRID.USE_HYBRID = False
    _C.DATA.HYBRID.IMAGES_DIR = ""
    _C.DATA.HYBRID.FILE_EXTENSION = ".jpg"
    _C.DATA.HYBRID.ALLOW_MISSING_IMAGES = False
    _C.DATA.HYBRID.VERIFY_IMAGES = CN()
    _C.DATA.HYBRID.VERIFY_IMAGES.ENABLED = False
    _C.DATA.HYBRID.VERIFY_IMAGES.MAX_MISSING_RATIO = 0.0
    _C.DATA.HYBRID.VERIFY_IMAGES.MAX_MISSING_COUNT = 0
    _C.DATA.HYBRID.VERIFY_IMAGES.NUM_WORKERS = 8
    _C.DATA.HYBRID.VERIFY_IMAGES.CHUNK_SIZE = 1000
    _C.DATA.HYBRID.VERIFY_IMAGES.LOG_MISSING = True

    _C.DATA.PREFETCH = CN()
    _C.DATA.PREFETCH.MEM_CACHE_SIZE = 10 * 1024 * 1024 * 1024
    _C.DATA.PREFETCH.BATCH_CONCURRENCY = 4
    _C.DATA.PREFETCH.MAX_PROCESSED_BATCHES = 10
    _C.DATA.PREFETCH.NUM_IO_THREADS = 4
    _C.DATA.PREFETCH.NUM_PREPROCESS_THREADS = 4
    _C.DATA.PREFETCH.SLEEP_TIME = 0.0
    # TPU-specific: number of batches kept resident in HBM ahead of compute.
    _C.DATA.PREFETCH.DEVICE_PREFETCH_DEPTH = 2

    _C.DATA.DATASET_META = CN(new_allowed=True)

    # ------------------------------------------------------------------ AUG
    _C.AUG = CN()
    _C.AUG.FROM = ""
    # 'device' fuses augmentation into the jitted train step (TPU-native
    # default); 'cpu' runs it on the host JAX CPU backend in the loader
    # (reference default, aug/factory.py:14-44)
    _C.AUG.SINGLE_AUG_DEVICE = "device"
    _C.AUG.USE_OPENCV = False  # parity no-op: decode is PIL/numpy here
    _C.AUG.AUTOAUG = CN()
    _C.AUG.AUTOAUG.POLICY = "original"
    _C.AUG.AUTOAUG.COLOR_JITTER = 0.4
    _C.AUG.RANDOM_ERASE = CN()
    _C.AUG.RANDOM_ERASE.PROB = 0.25
    _C.AUG.RANDOM_ERASE.MODE = "pixel"
    _C.AUG.RANDOM_ERASE.COUNT = 1
    _C.AUG.RANDOM_ERASE.AREA_RANGE = [0.02, 0.4]
    _C.AUG.RANDOM_ERASE.ASPECT_RATIO = [0.3, 3.3]

    # ------------------------------------------------------------------ MODEL
    _C.MODEL = CN()
    _C.MODEL.BASE = [""]
    _C.MODEL.TYPE = "mFormerV0"
    _C.MODEL.NAME = "mFormerV0_base"
    _C.MODEL.PRETRAINED = None
    _C.MODEL.PRETRAINED_SOURCE = None
    _C.MODEL.PRETRAINED_CONVNEXT = None
    _C.MODEL.PRETRAINED_ROPEVIT = None
    _C.MODEL.NUM_CLASSES = []
    _C.MODEL.DROP_RATE = 0.0
    _C.MODEL.DROP_PATH_RATE = 0.1
    _C.MODEL.ATTN_DROP_RATE = 0.0
    _C.MODEL.LABEL_SMOOTHING = 0.1
    _C.MODEL.ONLY_LAST_CLS = False
    # parity no-op: extra-token count is DERIVED from DATA.META.COMPONENTS
    # (1 cls + one per enabled component), matching the reference's own
    # derivation in inference/model_utils.py:109-118
    _C.MODEL.EXTRA_TOKEN_NUM = 3
    _C.MODEL.META_DIMS = []  # legacy fallback; prefer DATA.META.COMPONENTS
    _C.MODEL.IMG_SIZE = 384
    _C.MODEL.IN_CHANS = 3
    _C.MODEL.USE_FLASH_ATTN = False  # Pallas fused attention kernel
    # fp32-stored attention scores (reference parity). False = serving knob:
    # scores/probs stored in the compute dtype, softmax math still f32.
    # False = attention scores STORED in bf16 (softmax math still f32
    # in-fusion): measured +10% train (70.6 -> 64.0 ms/step) and +33%
    # inference for mFormerV1_sm @224. This is the production default —
    # mirroring the reference's own fp16 flash-attn path
    # (rope_2d_mhsa.py:459-491); set True for bitwise parity work against
    # fp32-softmax reference checkpoints (module defaults stay fp32, so
    # direct-instantiation parity tests are unaffected).
    _C.MODEL.ATTN_FP32_SOFTMAX = False
    # 'rotate' = correct 2D RoPE; 'reference_cos' reproduces the reference
    # implementation's silent complex->real cast (its rotation degrades to
    # cos(theta) scaling) for bit-compatibility with its trained checkpoints.
    _C.MODEL.ROPE_FIDELITY = "rotate"
    # weight-level RoPE pair de-interleave + head split (mathematically
    # equivalent, ~4 ms/step faster at B=128/224px — see
    # models/blocks/rope_mhsa.py); False keeps the plain nn.Dense qkv
    # layout for A/B measurements.
    _C.MODEL.ROPE_DEINTERLEAVE = True
    # Pallas fused ConvNeXt MLP (ops/fused_mlp.py): 'auto' routes by
    # measured geometry, serving and training alike (+33% serving /
    # +12% train step at 384px B=64 — training uses the hand-written
    # Pallas backward); 'on'/'off' force. Same parameter tree either
    # way (mFormerV1 only).
    _C.MODEL.FUSED_CONVNEXT_MLP = "auto"
    # mFormerV0 analog of the same layout rewrite: weight-level head
    # split/merge in RelativeAttention (no RoPE pairs to de-interleave).
    # Default off — measured neutral-to-slightly-slower there (negative
    # result, docs/performance.md); the knob stays for A/B runs.
    _C.MODEL.ATTN_HEAD_SPLIT = False
    # erf GELU (torch-exact) vs tanh approximation (default; ~1.5x faster
    # end-to-end on v5e with negligible accuracy impact)
    _C.MODEL.ACT_EXACT_GELU = False
    _C.MODEL.FIND_UNUSED_PARAMETERS = False  # parity no-op (no DDP on TPU)

    # ---- Mixture-of-Experts capacity scaling (no reference analog) ----
    # Replaces the dense MLP on every EVERY_N-th RoPE block (V-MoE
    # placement) with a routed expert bank (models/blocks/moe.py). Expert
    # weight banks shard over the 'model' mesh axis under
    # PARALLEL.PARAM_SHARDING='ep' (expert parallelism). mFormerV1 only.
    _C.MODEL.MOE = CN()
    _C.MODEL.MOE.ENABLED = False
    _C.MODEL.MOE.NUM_EXPERTS = 8
    _C.MODEL.MOE.TOP_K = 2
    _C.MODEL.MOE.CAPACITY_FACTOR = 1.25
    _C.MODEL.MOE.EVERY_N = 2
    # train-time router logit noise std (in units of 1/NUM_EXPERTS)
    _C.MODEL.MOE.NOISE_STD = 0.0
    # Switch-style load-balance loss weight (0 disables collection)
    _C.MODEL.MOE.AUX_LOSS_WEIGHT = 0.01
    # router z-loss weight (logit magnitude control, ST-MoE)
    _C.MODEL.MOE.ROUTER_Z_LOSS_WEIGHT = 0.001

    _C.MODEL.FEATURE_RESOLVER = CN()
    _C.MODEL.FEATURE_RESOLVER.TYPE = "LearnedProjection"
    _C.MODEL.FEATURE_RESOLVER.PROJECTION_INIT_MATRIX = "xavier"  # inert in the reference too
    _C.MODEL.FEATURE_RESOLVER.PARAMETERS = CN(new_allowed=True)
    _C.MODEL.FEATURE_RESOLVER.PARAMETERS.projection_dim = 512

    _C.MODEL.ATTENTION_MECHANISM = CN()
    _C.MODEL.ATTENTION_MECHANISM.HIERARCHICAL_ATTENTION = CN(new_allowed=True)
    _C.MODEL.ATTENTION_MECHANISM.HIERARCHICAL_ATTENTION.ACTIVE = False

    _C.MODEL.AGGREGATION = CN()
    _C.MODEL.AGGREGATION.TYPE = "default"
    _C.MODEL.AGGREGATION.PARAMETERS = CN(new_allowed=True)
    # NORM_LAYER/ACTIVATION: inert in the reference too (read by nothing)
    _C.MODEL.AGGREGATION.PARAMETERS.NORM_LAYER = "LayerNorm"
    _C.MODEL.AGGREGATION.PARAMETERS.ACTIVATION = "GELU"

    _C.MODEL.CLASSIFICATION = CN()
    _C.MODEL.CLASSIFICATION.HEADS = CN(new_allowed=True)

    # MODEL.NORMALIZATION.*: inert in the reference too — models hard-code
    # their norm/activation choices (as do ours: BN in MBConv, LN elsewhere)
    _C.MODEL.NORMALIZATION = CN()
    _C.MODEL.NORMALIZATION.CONV_NORM_LAYER = "BatchNorm2d"
    _C.MODEL.NORMALIZATION.ATTENTION_NORM_LAYER = "LayerNorm"
    _C.MODEL.NORMALIZATION.ACTIVATION_LAYER = "GELU"

    _C.MODEL.OTHER_COMPONENTS = CN()
    _C.MODEL.OTHER_COMPONENTS.DOWNSAMPLE_LAYERS = False  # inert in the reference too

    # mFormerV1 stage configs (filled by model-base YAMLs; listed here so the
    # keys exist for merge validation)
    _C.MODEL.CONVNEXT_STAGES = CN(new_allowed=True)
    _C.MODEL.ROPE_STAGES = CN(new_allowed=True)
    # mFormerV0 stage config
    _C.MODEL.STAGES = CN(new_allowed=True)

    # ------------------------------------------------------------------ LOSS
    _C.LOSS = CN()
    _C.LOSS.FROM = ""
    _C.LOSS.TASK_SPECIFIC = CN()
    _C.LOSS.TASK_SPECIFIC.TRAIN = CN()
    _C.LOSS.TASK_SPECIFIC.TRAIN.FUNCS = ["CrossEntropyLoss"] * 4
    _C.LOSS.TASK_SPECIFIC.VAL = CN()
    _C.LOSS.TASK_SPECIFIC.VAL.FUNCS = ["CrossEntropyLoss"] * 4

    _C.LOSS.GRAD_WEIGHTING = CN()
    _C.LOSS.GRAD_WEIGHTING.TASK = CN()
    _C.LOSS.GRAD_WEIGHTING.TASK.TYPE = "gradnorm"  # 'static' or 'gradnorm'
    _C.LOSS.GRAD_WEIGHTING.TASK.ALPHA = 1.5
    _C.LOSS.GRAD_WEIGHTING.TASK.UPDATE_INTERVAL = 100
    _C.LOSS.GRAD_WEIGHTING.TASK.INIT_STRATEGY = "inverse_density"
    _C.LOSS.GRAD_WEIGHTING.TASK.INIT_WEIGHTS = []
    _C.LOSS.GRAD_WEIGHTING.TASK.EXCLUDE_CONFIG = CN(new_allowed=True)
    _C.LOSS.GRAD_WEIGHTING.TASK.EXCLUDE_CONFIG.TYPE = "or"
    _C.LOSS.GRAD_WEIGHTING.TASK.EXCLUDE_CONFIG.FILTERS = [
        {"TYPE": "name", "PATTERNS": ["head"]},
        {"TYPE": "name", "PATTERNS": ["meta_"]},
    ]
    _C.LOSS.GRAD_WEIGHTING.TASK.EXCLUDE_PATTERNS = ["head", "meta_"]
    _C.LOSS.GRAD_WEIGHTING.TASK.GRADNORM_ENABLED = True
    _C.LOSS.GRAD_WEIGHTING.TASK.GRADNORM_WARMUP_STEPS = 0
    _C.LOSS.GRAD_WEIGHTING.TASK.ZERO_AUX_INFO = True
    _C.LOSS.GRAD_WEIGHTING.TASK.GRADNORM_ACCUM_STEPS = 1
    _C.LOSS.GRAD_WEIGHTING.TASK.USE_LINEAR_HEADS_FOR_GRADNORM_REFORWARD = True
    _C.LOSS.GRAD_WEIGHTING.SUBSET = CN(new_allowed=True)
    _C.LOSS.GRAD_WEIGHTING.TAXALIGN = CN(new_allowed=True)  # compat stub
    _C.LOSS.GRAD_WEIGHTING.CLASS = CN(new_allowed=True)
    _C.LOSS.GRAD_WEIGHTING.CLASS.TRAIN = True
    _C.LOSS.GRAD_WEIGHTING.CLASS.VAL = False

    _C.LOSS.TAXONOMY_SMOOTHING = CN()
    _C.LOSS.TAXONOMY_SMOOTHING.ENABLED = [False] * 4
    _C.LOSS.TAXONOMY_SMOOTHING.ALPHA = 0.1
    _C.LOSS.TAXONOMY_SMOOTHING.BETA = 1.0
    _C.LOSS.TAXONOMY_SMOOTHING.UNIFORM_ROOTS = True
    _C.LOSS.TAXONOMY_SMOOTHING.FALLBACK_TO_UNIFORM = True
    _C.LOSS.TAXONOMY_SMOOTHING.PARTIAL_SUBTREE_WEIGHTING = False  # inert in the reference too

    # ------------------------------------------------------------------ TRAIN
    _C.TRAIN = CN()
    _C.TRAIN.FROM = ""
    _C.TRAIN.START_EPOCH = 0
    _C.TRAIN.EPOCHS = 300
    _C.TRAIN.CLIP_GRAD = 5.0
    _C.TRAIN.ACCUMULATION_STEPS = 0
    _C.TRAIN.AUTO_RESUME = True
    # Parameter EMA (beyond-reference): a moving average of params updated
    # inside the jitted step; validation (and exported bundles) can read it
    # in place of the raw params. timm-style fixed decay, no debiasing.
    _C.TRAIN.EMA = CN()
    _C.TRAIN.EMA.ENABLED = False
    _C.TRAIN.EMA.DECAY = 0.9998
    # validate (and pick checkpoints) on the EMA weights
    _C.TRAIN.EMA.EVAL = True
    _C.TRAIN.ALLOW_WANDB_VAL_CHANGE = True
    _C.TRAIN.GRADIENT_CHECKPOINTING = CN()
    _C.TRAIN.GRADIENT_CHECKPOINTING.ENABLED_NORMAL_STEPS = True
    _C.TRAIN.GRADIENT_CHECKPOINTING.ENABLED_GRADNORM_STEPS = True
    # remat policy when checkpointing is on: 'dots' (default: save
    # matmul outputs, recompute only elementwise/LN — measured 10%
    # faster than 'full' at sm/B=128 and 28x at xl, where 'full' is
    # pathological: 2566 ms/step), 'full' (save nothing, maximum
    # memory savings), 'dots_no_batch' (weight-shaped dot outputs
    # only). Gradients identical under every policy (models/utils.py).
    _C.TRAIN.GRADIENT_CHECKPOINTING.POLICY = "dots"
    _C.TRAIN.PHASE1_MASK_NULL_LOSS = False
    _C.TRAIN.PRESERVE_CHECKPOINT_SCHEDULE = False
    # Kept for reference parity; maps onto MIXED_PRECISION below
    # ("O0" -> float32, otherwise bfloat16).
    _C.TRAIN.AMP_OPT_LEVEL = "O1"
    # TPU-native mixed precision: compute dtype for the forward/backward pass.
    # Params and optimizer state stay fp32; bf16 is MXU-native (no loss scaler
    # needed, unlike fp16+AMP on CUDA).
    _C.TRAIN.MIXED_PRECISION = CN()
    _C.TRAIN.MIXED_PRECISION.ENABLED = True
    _C.TRAIN.MIXED_PRECISION.DTYPE = "bfloat16"

    _C.TRAIN.EARLY_STOP = CN()
    _C.TRAIN.EARLY_STOP.ACTIVE = False
    _C.TRAIN.EARLY_STOP.METRIC = "val_loss"
    _C.TRAIN.EARLY_STOP.MAX_STEPS = None
    _C.TRAIN.EARLY_STOP.PATIENCE_STEPS = 2000
    _C.TRAIN.EARLY_STOP.MIN_DELTA = None
    _C.TRAIN.EARLY_STOP.MAX_LOSS = None
    _C.TRAIN.EARLY_STOP.MIN_LR = None
    _C.TRAIN.EARLY_STOP.MAX_GRAD_NORM = None

    # ------------------------------------------------------------------ VAL
    # legacy validation cadence block (reference config.py:524+): superseded
    # by SCHEDULE.VALIDATION.* here; kept so reference YAMLs merge unchanged
    _C.VAL = CN()
    _C.VAL.FROM = ""
    _C.VAL.CROP = True
    _C.VAL.VAL_INTERVAL = 1
    _C.VAL.MASK_META_TEST = True
    _C.VAL.MASK_META_VAL_INTERVAL = 20
    _C.VAL.DISABLE_AUGMENTATIONS = True

    # ------------------------------------------------------------------ OPTIMIZER
    _C.OPTIMIZER = CN()
    _C.OPTIMIZER.FROM = ""
    _C.OPTIMIZER.NAME = "adamw"
    _C.OPTIMIZER.EPS = 1e-8
    _C.OPTIMIZER.BETAS = (0.9, 0.999, 0.9999)
    _C.OPTIMIZER.MOMENTUM = 0.9
    _C.OPTIMIZER.WEIGHT_DECAY = 0.05
    _C.OPTIMIZER.ALPHA = 5.0
    _C.OPTIMIZER.T_ALPHA_BETA3 = None
    _C.OPTIMIZER.MUON = CN()
    _C.OPTIMIZER.MUON.MOMENTUM = 0.95
    _C.OPTIMIZER.MUON.NESTEROV = True
    _C.OPTIMIZER.MUON.NS_STEPS = 5
    _C.OPTIMIZER.MUON.USE_DISTRIBUTED = True  # parity no-op: XLA shards for us
    _C.OPTIMIZER.MUON.STRICT = False
    _C.OPTIMIZER.MUON.APPLY_SCALING = True
    _C.OPTIMIZER.PARAMETER_GROUPS = CN(new_allowed=True)
    _C.OPTIMIZER.PARAMETER_GROUPS.ENABLED = False
    _C.OPTIMIZER.PARAMETER_GROUPS.DEFAULT = CN()
    _C.OPTIMIZER.PARAMETER_GROUPS.DEFAULT.OPTIMIZER = "adamw"
    _C.OPTIMIZER.PARAMETER_GROUPS.DEFAULT.WEIGHT_DECAY = 0.05
    _C.OPTIMIZER.PARAMETER_GROUPS.DEFAULT.LR_MULTIPLIER = 1.0

    # ------------------------------------------------------------------ LR_SCHEDULER
    _C.LR_SCHEDULER = CN()
    _C.LR_SCHEDULER.FROM = ""
    _C.LR_SCHEDULER.NAME = "cosine"
    _C.LR_SCHEDULER.REFERENCE_BS = 512
    # REFERENCE_LR: informational, logged alongside scaling (the reference
    # uses it only in its log lines too — schedule_utils.py:492's actual
    # multiplication scales each param group's configured LR)
    _C.LR_SCHEDULER.REFERENCE_LR = 5e-5
    # computed by apply_lr_scaling; per-group BASE_LR overrides in
    # LR_SCHEDULER.PARAMETER_GROUPS are multiplied by this same factor
    _C.LR_SCHEDULER.LR_SCALING_FACTOR = 1.0
    _C.LR_SCHEDULER.WARMUP_EPOCHS = 5.0
    _C.LR_SCHEDULER.WARMUP_FRACTION = None
    _C.LR_SCHEDULER.WARMUP_STEPS = 0
    _C.LR_SCHEDULER.TOTAL_STEPS = 50000
    _C.LR_SCHEDULER.BASE_LR = 1e-4
    _C.LR_SCHEDULER.WARMUP_LR = 5e-7
    _C.LR_SCHEDULER.MIN_LR = 1e-5
    _C.LR_SCHEDULER.DECAY_STEPS = 5000
    _C.LR_SCHEDULER.DECAY_FRACTION = None
    _C.LR_SCHEDULER.DECAY_RATE = 0.1
    _C.LR_SCHEDULER.STABLE_DURATION_FRACTION = 0.8
    _C.LR_SCHEDULER.DECAY_DURATION_FRACTION = 0.1
    _C.LR_SCHEDULER.DECAY_TYPE = "cosine"
    _C.LR_SCHEDULER.PARAMETER_GROUPS = CN(new_allowed=True)
    _C.LR_SCHEDULER.PARAMETER_GROUPS.ENABLED = False

    # ------------------------------------------------------------------ SCHEDULE
    _C.SCHEDULE = CN()
    _C.SCHEDULE.META_MASKING = CN()
    _C.SCHEDULE.META_MASKING.ENABLED = True
    _C.SCHEDULE.META_MASKING.START_PROB = 1.0
    _C.SCHEDULE.META_MASKING.END_PROB = 0.0
    _C.SCHEDULE.META_MASKING.END_STEPS = 0
    _C.SCHEDULE.META_MASKING.END_FRACTION = None
    _C.SCHEDULE.META_MASKING.PARTIAL = CN()
    _C.SCHEDULE.META_MASKING.PARTIAL.ENABLED = False
    _C.SCHEDULE.META_MASKING.PARTIAL.START_STEPS = 0
    _C.SCHEDULE.META_MASKING.PARTIAL.START_FRACTION = None
    _C.SCHEDULE.META_MASKING.PARTIAL.END_STEPS = 0
    _C.SCHEDULE.META_MASKING.PARTIAL.END_FRACTION = None
    _C.SCHEDULE.META_MASKING.PARTIAL.START_PROB = 0.01
    _C.SCHEDULE.META_MASKING.PARTIAL.END_PROB = 0.7
    _C.SCHEDULE.META_MASKING.PARTIAL.PROB_END_STEPS = 0
    _C.SCHEDULE.META_MASKING.PARTIAL.PROB_END_FRACTION = 0.5
    _C.SCHEDULE.META_MASKING.PARTIAL.WHITELIST = []
    _C.SCHEDULE.META_MASKING.PARTIAL.WEIGHTS = []

    _C.SCHEDULE.NULL_MASKING = CN()
    _C.SCHEDULE.NULL_MASKING.ENABLED = False
    _C.SCHEDULE.NULL_MASKING.START_PROB = 0.0
    _C.SCHEDULE.NULL_MASKING.END_PROB = 1.0
    _C.SCHEDULE.NULL_MASKING.END_STEPS = 15000
    _C.SCHEDULE.NULL_MASKING.END_FRACTION = None

    _C.SCHEDULE.MIX = CN()
    _C.SCHEDULE.MIX.GROUP_LEVELS = ["taxa_L40", "taxa_L30", "taxa_L20", "taxa_L10"]
    _C.SCHEDULE.MIX.LEVEL_SWITCH_EPOCHS = []
    _C.SCHEDULE.MIX.LEVEL_SWITCH_STEPS = []
    _C.SCHEDULE.MIX.PROB = CN()
    _C.SCHEDULE.MIX.PROB.ENABLED = True
    _C.SCHEDULE.MIX.PROB.START_PROB = 1.0
    _C.SCHEDULE.MIX.PROB.END_PROB = 0.2
    _C.SCHEDULE.MIX.PROB.END_STEPS = 0
    _C.SCHEDULE.MIX.PROB.END_FRACTION = None
    _C.SCHEDULE.MIX.USE_GPU = True  # parity alias for "apply on device (in-jit)"
    _C.SCHEDULE.MIX.MIN_GROUP_SIZE = 4
    _C.SCHEDULE.MIX.EXCLUDE_NULL_SAMPLES = False
    # DEPRECATED in the reference (aug/cpu/selective_mixup.py:58); chunk
    # bounds are derived from DATA.META.COMPONENTS (utils/meta.py)
    _C.SCHEDULE.MIX.CHUNK_BOUNDS = []
    _C.SCHEDULE.MIX.NULL_TASK_KEYS = None
    _C.SCHEDULE.MIX.SWITCH_PROB = 0.5
    _C.SCHEDULE.MIX.MIXUP = CN()
    _C.SCHEDULE.MIX.MIXUP.ENABLED = True
    _C.SCHEDULE.MIX.MIXUP.ALPHA = 1.0
    _C.SCHEDULE.MIX.CUTMIX = CN()
    _C.SCHEDULE.MIX.CUTMIX.ENABLED = False
    _C.SCHEDULE.MIX.CUTMIX.ALPHA = 1.0
    _C.SCHEDULE.MIX.CUTMIX.MINMAX = None

    _C.SCHEDULE.METRICS = CN()
    _C.SCHEDULE.METRICS.WANDB_INTERVAL = 50
    _C.SCHEDULE.METRICS.WANDB_FRACTION = None
    _C.SCHEDULE.METRICS.CONSOLE_INTERVAL = 100
    _C.SCHEDULE.METRICS.CONSOLE_FRACTION = None
    _C.SCHEDULE.METRICS.LR_INTERVAL = 100
    _C.SCHEDULE.METRICS.LR_FRACTION = None
    _C.SCHEDULE.METRICS.PIPELINE_INTERVAL = 250
    _C.SCHEDULE.METRICS.PIPELINE_FRACTION = None

    _C.SCHEDULE.VALIDATION = CN()
    _C.SCHEDULE.VALIDATION.INTERVAL_EPOCHS = 1
    _C.SCHEDULE.VALIDATION.INTERVAL_STEPS = 0
    _C.SCHEDULE.VALIDATION.INTERVAL_FRACTION = None
    _C.SCHEDULE.VALIDATION.MASK_META_INTERVAL_EPOCHS = 1
    _C.SCHEDULE.VALIDATION.MASK_META_INTERVAL_STEPS = 0
    _C.SCHEDULE.VALIDATION.MASK_META_INTERVAL_FRACTION = None
    _C.SCHEDULE.VALIDATION.PARTIAL_MASK_META = CN()
    _C.SCHEDULE.VALIDATION.PARTIAL_MASK_META.ENABLED = False
    _C.SCHEDULE.VALIDATION.PARTIAL_MASK_META.INTERVAL_EPOCHS = 0
    _C.SCHEDULE.VALIDATION.PARTIAL_MASK_META.INTERVAL_STEPS = 0
    _C.SCHEDULE.VALIDATION.PARTIAL_MASK_META.INTERVAL_FRACTION = None
    _C.SCHEDULE.VALIDATION.PARTIAL_MASK_META.WHITELIST = []
    _C.SCHEDULE.VALIDATION.FINAL_EPOCH = CN()
    _C.SCHEDULE.VALIDATION.FINAL_EPOCH.EXHAUSTIVE_PARTIAL_META_VALIDATION = False
    _C.SCHEDULE.VALIDATION.FINAL_EPOCH.EXHAUSTIVE_META_COMPONENTS = []

    _C.SCHEDULE.CHECKPOINT = CN()
    _C.SCHEDULE.CHECKPOINT.INTERVAL_EPOCHS = 1
    _C.SCHEDULE.CHECKPOINT.INTERVAL_STEPS = 0
    _C.SCHEDULE.CHECKPOINT.INTERVAL_FRACTION = None
    _C.SCHEDULE.CHECKPOINT.KEEP_TOP_N = 0
    _C.SCHEDULE.CHECKPOINT.KEEP_LAST_N = 0
    # Async array flush: Orbax writes checkpoints on a background thread so
    # the hot loop resumes immediately after the host snapshot; waited at
    # resume/preemption/exit and before bucket syncs (utils/checkpoint.py::
    # CheckpointWriter). The reference blocks its loop on torch.save.
    _C.SCHEDULE.CHECKPOINT.ASYNC = True

    # ------------------------------------------------------------------ PARALLEL (TPU-native)
    _C.PARALLEL = CN()
    # Mesh axis sizes. -1 on DATA means "all remaining devices".
    _C.PARALLEL.MESH = CN()
    _C.PARALLEL.MESH.DATA = -1
    _C.PARALLEL.MESH.MODEL = 1
    # Sharding of params: 'replicated' (pure DP), 'fsdp' (shard each param's
    # largest axis along the data axis), 'tp' (Megatron column/row-parallel
    # transformer projections over the model axis — set MESH.MODEL > 1), or
    # 'ep' (expert parallelism: MoE expert banks shard over the model axis;
    # requires MODEL.MOE.ENABLED and MESH.MODEL > 1)
    _C.PARALLEL.PARAM_SHARDING = "replicated"
    # Sequence parallelism: run RoPE attention as a ppermute ring over the
    # model axis (ops/ring_attention.py) — the token dim shards across
    # chips, for inputs whose stage-3 token tensor exceeds one chip's HBM
    # (1024px+). Requires MESH.MODEL > 1 and MODEL.TYPE=mFormerV1.
    _C.PARALLEL.SEQUENCE_PARALLEL = False
    # GPipe pipeline parallelism (parallel/pipeline.py): STAGES > 1 routes
    # the mFormerV1 RoPE towers through pipeline_forward over the 'model'
    # mesh axis — each device holds depth/STAGES contiguous blocks;
    # microbatched activations ppermute between stages; backward is the
    # reverse pipeline through the scan. Requires PARALLEL.MESH.MODEL ==
    # STAGES, stage-3 depth divisible by STAGES, and uniform towers
    # (no MoE, DROP_PATH_RATE 0 — stochastic-depth RNG does not thread
    # through the pipelined scan). Incompatible with PARAM_SHARDING
    # 'tp'/'ep' and SEQUENCE_PARALLEL (all claim the model axis).
    # mFormerV1 only. Stage 4 also pipelines when its depth divides STAGES;
    # otherwise it runs sequentially (logged).
    _C.PARALLEL.PIPELINE = CN()
    _C.PARALLEL.PIPELINE.STAGES = 1
    # microbatches per batch (M >= STAGES; bubble fraction (S-1)/(M+S-1));
    # 0 -> defaults to STAGES
    _C.PARALLEL.PIPELINE.MICROBATCHES = 0
    # Use jax.distributed.initialize() for multi-host
    _C.PARALLEL.MULTI_HOST = False

    # ------------------------------------------------------------------ MISC / DEBUG
    _C.MISC = CN()
    _C.MISC.SEED = 42
    # compat stub (reference config.py:915; superseded by
    # SCHEDULE.METRICS.PIPELINE_INTERVAL)
    _C.MISC.PIPELINE_METRICS_FREQ = 250
    _C.MISC.OUTPUT = "output"
    _C.MISC.SAVE_FREQ = 1
    _C.MISC.PRINT_FREQ = 50  # superseded by SCHEDULE.METRICS.CONSOLE_INTERVAL

    _C.DEBUG = CN()
    _C.DEBUG.VALIDATION_METRICS = False
    _C.DEBUG.DUMP_METRICS = False
    _C.DEBUG.VERBOSE_DEBUG = False
    _C.DEBUG.TRAIN_METRICS = False
    _C.DEBUG.WANDB_METRICS = False
    _C.DEBUG.SCHEDULING = False
    _C.DEBUG.CHECKPOINT = False
    _C.DEBUG.DATALOADER = False
    _C.DEBUG.AUGMENTATION = False
    _C.DEBUG.OPTIMIZER = False
    _C.DEBUG.DISTRIBUTED = False
    _C.DEBUG.MODEL_BUILD = False
    _C.DEBUG.TRAINING_LOOP = False
    _C.DEBUG.LOSS = CN()
    _C.DEBUG.LOSS.TAXONOMY_SMOOTHING = False
    _C.DEBUG.LOSS.NULL_MASKING = False
    _C.DEBUG.LOSS.CLASS_WEIGHTING = False  # inert in the reference too
    _C.DEBUG.LOSS.GRADNORM_MEMORY = False
    _C.DEBUG.LOSS.GRADNORM_METRICS = False
    _C.DEBUG.LOSS.VERBOSE_GRADNORM_LOGGING = False
    _C.DEBUG.METRICS = CN()
    _C.DEBUG.METRICS.AVG_METER_VERBOSE_ACTUAL_META_STATS = False
    _C.DEBUG.DATASET = CN()
    _C.DEBUG.DATASET.READ_ITEM_VERBOSE = False
    _C.DEBUG.EARLY_EXIT_AFTER_N_OPTIMIZER_STEPS = 0
    # jax.profiler trace window (TPU-native replacement for the reference's
    # pipeline-monitor-only profiling; SURVEY.md §5). 0/0 disables.
    _C.DEBUG.PROFILE = CN()
    _C.DEBUG.PROFILE.START_STEP = 0
    _C.DEBUG.PROFILE.END_STEP = 0

    _C.LOADING_FROM_CHECKPOINT = False

    return _C


_C = _build_default_config()


def get_config() -> CN:
    """Return a fresh clone of the default config."""
    return _C.clone()


def get_default_config() -> CN:
    """Alias of :func:`get_config` (reference parity: config.py:995-999)."""
    return get_config()
