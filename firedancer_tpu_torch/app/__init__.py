"""app — the port's operator binaries (fdctl, fddev, ctl), the
counterpart of ``firedancer_tpu/app/`` (the reference's src/app/)."""
