"""The plain reference: the physics, robots and tasks of the benchmark's
configurations in plain PyTorch, float32 with TF32 off, frozen here so that
the program under test cannot change what it is judged by. It imports
nothing of the program."""
