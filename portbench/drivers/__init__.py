"""One driver per entry of the port: ``serve`` (``Recognizer.decode_result``)
and ``train`` (the step of ``data/pipeline.make_audio_train_step``). A
mix's ``entry`` names its driver."""
