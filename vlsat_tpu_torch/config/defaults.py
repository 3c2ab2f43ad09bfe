"""Default experiment configuration (a copy of
``vlsat_tpu/config/defaults.py``: the same keys, values and allowed sets, so
a JAX experiment JSON loads unchanged).

Hyperparameters mirror the reference's shipped config (config/mmgnet.json):
LR 1e-4, cosine schedule, 100 epochs, batch 8, N_LAYERS 2, NUM_HEADS 8,
DIM_ATTEN 256, 'fat' attention, dropout 0.5, DYNAMIC edge weighting,
lambda_o 0.1, 128 points per instance.

Inert on the card, kept so that a JAX config validates and round-trips:
``PRNG_IMPL`` (a JAX PRNG choice; the port's dropout draws from a
``torch.Generator`` seeded per step) and ``COMPILE_CACHE_DIR`` (XLA's
persistent compile cache; the port compiles nothing ahead of time, and its
CUDA kernels are cached in ``vlsat_tpu_torch/_build/``).  The TPU-measured
notes of the JAX defaults are not repeated here: ``EVAL_BATCH_SIZE="auto"``
resolves to the port's own table (``data/bucket_batch.py``).
"""

DEFAULT_CONFIG = {
    "NAME": "Mmgnet",
    "_NAME": ["SGFN", "Mmgnet", "MmgnetSingle", "SGPN", "SGGpoint",
              "SGGpointBaseline", "MMteacher", "MmgnetIn21k"],
    "PATH": "./output",
    "SEED": 2020,
    # inert here: the JAX package's PRNG implementation
    "PRNG_IMPL": "rbg",
    "_PRNG_IMPL": ["rbg", "threefry2x32", "unsafe_rbg"],
    "MAX_EPOCHES": 100,
    "LR": 1e-4,
    "W_DECAY": 0.0,
    "LR_SCHEDULE": "Cosine",
    "_LR_SCHEDULE": ["Cosine", "BatchMultiplicative"],
    "SAVE_INTERVAL": 2000,
    "VALID_INTERVAL": 10,
    "LOG_INTERVAL": 100,
    "Batch_Size": 8,
    # K train steps per call (train/step.py make_multi_train_step)
    "TRAIN_MICROSTEPS": 1,
    # keep the packed train split on the card and gather minibatches by
    # index (data/resident.py); "auto": when it fits RESIDENT_HBM_BUDGET
    "TRAIN_RESIDENT": "auto",
    # the same residency for validation (data/resident.py)
    "EVAL_RESIDENT": "auto",
    # eval batches per output copy on the resident path
    # (data/resident.py ResidentGroupedEval); 1 disables grouping
    "EVAL_GROUP": 4,
    "RESIDENT_HBM_BUDGET": 2 << 30,
    # int = one batch size everywhere (1 mirrors the reference protocol;
    # metrics are batch-size independent); "auto" = the port's per-bucket
    # table (data/bucket_batch.py DEFAULT_EVAL_BATCH)
    "EVAL_BATCH_SIZE": 1,
    # inert here: the JAX package's persistent XLA compile cache
    "COMPILE_CACHE_DIR": "/tmp/vlsat_jax_cache",
    "EVAL": False,
    "VERBOSE": False,
    "exp": "default",
    "MODEL": {
        "N_LAYERS": 2,
        "USE_SPATIAL": True,
        "WITH_BN": False,
        "USE_RGB": False,
        "USE_NORMAL": False,
        "use_2d_feats": True,
        "USE_GCN_EDGE": True,
        "_GCN_TYPE": ["TRIP", "EAN"],
        "GCN_TYPE": "EAN",
        "_ATTENTION": ["fat"],
        "ATTENTION": "fat",
        "DROP_OUT_ATTEN": 0.5,
        "multi_rel_outputs": True,
        "point_feature_size": 768,
        "clip_feat_dim": 512,
        "lambda_o": 0.1,
        "DIM_ATTEN": 256,
        "_WEIGHT_EDGE": ["BG", "DYNAMIC", "OCCU", "NONE"],
        "WEIGHT_EDGE": "DYNAMIC",
        "_GCN_AGGR": ["add", "mean", "max"],
        "GCN_AGGR": "max",
        "w_bg": 1.0,
        "NONE_RATIO": 1.0,
        "NUM_HEADS": 8,
        "use_descriptor": True,
        "use_pretrain": "",
        "adapter_alpha": 0.5,
        # nn_edge node-projection placement: "edge" | "gather" | "onehot"
        # (algebraically identical)
        "nn_edge_mode": "edge",
        # CLIP assets: pre-computed text tables
        "obj_text_table": None,
        "rel_text_table": None,
        "triplet_text_cache": None,
        "adapter_weights": None,
    },
    "dataset": {
        "root": "./assets/3dssg",
        "scans_root": None,            # 3RScan directory with per-scan PLYs
        "multi_view_root": None,       # per-instance CLIP feature .npy root
        "cache_root": None,            # preprocessed tensor cache
        # packed per-bucket tensor cache (data/packed.py): a directory with
        # train/ and validation/ packs, read as mmap slices
        "packed_root": None,
        "label_file": "labels.instances.align.annotated.v2.ply",
        "num_points": 128,
        "num_points_union": 256,
        "use_data_augmentation": False,
        "node_buckets": [4, 8, 12, 16, 24, 32, 48, 64],
        "with_union_points": False,    # only the SGPN-style configs need them
        # runtime BFS subgraph sampling (reference config/mmgnet.json:79-83,
        # consumed by the legacy util_data.py data_preparation path)
        "sample_in_runtime": False,
        "sample_num_nn": 2,
        "sample_num_seed": 4,
        "max_edges": -1,
        "neighbor_radius": 0.5,
    },
}
