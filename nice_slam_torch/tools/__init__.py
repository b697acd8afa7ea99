"""Tools of the port: measurements on the GPU (decode_ablation,
scatter_bench) and decoder pretraining (pretrain_decoders)."""
