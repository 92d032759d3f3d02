"""The port's models; :func:`build_model_from_config` picks one from a
config, as ``mm_s2ut/models/__init__.py`` does."""


def build_model_from_config(cfg):
    """``Config`` → the model its task runs: ``MMXMTransformerModel`` for
    ``task: multimodal_speech_to_text``, else ``MMS2UTModel``, each with the
    wav2vec2 geometry of ``model.w2v_args``. Built in ``model.dtype`` on the
    CPU; the architecture presets are applied by the tasks, not here."""
    from mm_s2ut_torch.models.mm_s2ut import MMS2UTModel
    from mm_s2ut_torch.models.mm_xm import MMXMTransformerModel
    from mm_s2ut_torch.models.wav2vec2 import Wav2Vec2Config

    w2v_cfg = Wav2Vec2Config.from_args(cfg.model.w2v_args)
    if cfg.task == "multimodal_speech_to_text":
        return MMXMTransformerModel(cfg.model, w2v_cfg=w2v_cfg)
    return MMS2UTModel(cfg.model, w2v_cfg=w2v_cfg)
