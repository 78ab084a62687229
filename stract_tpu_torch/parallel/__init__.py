from .mesh import make_mesh
from .train import make_train_state, ranking_loss, train_step
