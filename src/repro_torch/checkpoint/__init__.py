from repro_torch.checkpoint.io import load_pytree, save_pytree
from repro_torch.checkpoint.state import (
    Checkpointer, find_latest_publish, find_resume_point, list_checkpoints,
    list_publishes, load_publish, load_train_state, save_publish,
    save_train_state, state_step,
)
