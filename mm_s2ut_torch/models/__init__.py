"""The port's models; :func:`build_model_from_config` picks one from a
config, as ``mm_s2ut/models/__init__.py`` does."""


def build_model_from_config(cfg):
    """``Config`` → the model its task runs: ``MMXMTransformerModel`` for
    ``task: multimodal_speech_to_text``, else ``MMS2UTModel``, each with the
    wav2vec2 geometry of ``model.w2v_args``; the on-line image encoder's
    config is ``multimodal.visual_extractor_args`` over its type's default
    (``image_size`` from ``multimodal.image_input_size``). Built in ``model.dtype`` on the
    CPU; the architecture presets are applied by the tasks, not here."""
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config

    mm = cfg.model.multimodal
    vit_cfg = None
    if mm.load_visual_extractor_type:
        from mm_s2ut_torch.models.vit import CLIPVisionConfig, ViTConfig

        base = CLIPVisionConfig if mm.load_visual_extractor_type == "vit_openai" else ViTConfig
        args = dict(mm.visual_extractor_args)
        args.setdefault("image_size", mm.image_input_size)
        vit_cfg = base(**args)
    w2v_cfg = Wav2Vec2Config.from_args(cfg.model.w2v_args)
    if cfg.task == "multimodal_speech_to_text":
        return MMXMTransformerModel(cfg.model, w2v_cfg=w2v_cfg)
    return MMS2UTModel(cfg.model, w2v_cfg=w2v_cfg, vit_cfg=vit_cfg)
