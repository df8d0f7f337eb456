"""certificate_ms (ms, program span): the card's time in the certificate
part of one record (the port's ``record.certificate`` span, ``device_s``)
per record round, in the traced solve. Nothing where the recorder has no
certificate."""
from colabench import program_spans


def read(record):
    return program_spans.ms("record.certificate", "device_s")
