# Entry points (port of `repro.launch`): the serving loop and its step
# function.
