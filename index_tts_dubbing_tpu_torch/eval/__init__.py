from index_tts_dubbing_tpu_torch.eval.wer import wer, normalize_for_wer  # noqa: F401
from index_tts_dubbing_tpu_torch.eval.speaker_sim import speaker_similarity  # noqa: F401
