"""Device ms per train step of the kernels launched under the optimizer's
``Optimizer.step#RMSprop.step`` range."""

PREFIX = "Optimizer.step#"
UNDER = (PREFIX,)
PROFILE = True


def read(record):
    profile = record.profile
    if profile is None or not profile.iterations or not profile.under.get(
            PREFIX):
        return None
    return profile.under[PREFIX] / 1e3 / profile.iterations
