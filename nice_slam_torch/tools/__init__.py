"""Tools of the port: measurements on the GPU (decode_ablation,
scatter_bench), decoder pretraining (pretrain_decoders), the evaluation
tools (eval_ate, cull_mesh, eval_recon), a scene yaml for a capture of
one's own (prep_own_data) and the trajectory replay with its WebGL viewer
(replay, viewer_template.html)."""
