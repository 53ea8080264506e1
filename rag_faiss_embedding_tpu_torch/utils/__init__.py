from .text import sentence_split, tf_vector, cosine_sim
from .timers import StageTimer
