"""Set-up seconds: from the start of ``run.py`` to the end of the warm-up
(imports, the device's context, kernel builds or loads, the data made on
the device, the program's set-up and the warm requests), host clock."""


def read(ctx):
    return ctx.setup_s
