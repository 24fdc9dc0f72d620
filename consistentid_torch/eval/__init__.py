from .metrics import CLIPTScorer, FaceSimScorer, face_similarity
from .runner import SweepResult, SweepRow, load_sweep_csv, run_sweep
from .styles import DEFAULT_STYLE, STYLES, apply_style
from .baselines import PhotoMakerIDEncoder, photomaker_vision_config
