"""The plain references the benchmark judges the program by: f32 PyTorch, TF32 off,
written from the models' definitions. Nothing here imports the program."""
