from repro_torch.train.step import TrainState, make_train_step

__all__ = ["TrainState", "make_train_step"]
