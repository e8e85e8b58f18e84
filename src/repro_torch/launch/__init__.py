# Entry points (port of `repro.launch`): the serving loop, the training
# driver and the train, serve and prefill step functions.
