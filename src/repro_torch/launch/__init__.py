# Entry points (port of `repro.launch`): the serving loop and the serve
# and prefill step functions.
