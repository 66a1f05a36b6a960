from .loading import load_audio_file, prepare_waveform, resample, to_mono
from .mel import LogMelExtractor, mel_filter_bank

__all__ = ["LogMelExtractor", "load_audio_file", "mel_filter_bank", "prepare_waveform", "resample", "to_mono"]
