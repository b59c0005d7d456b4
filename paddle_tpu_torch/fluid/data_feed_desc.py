"""DataFeedDesc (copy of ``paddle_tpu/fluid/data_feed_desc.py``;
reference: python/paddle/fluid/data_feed_desc.py:21) —
describes the MultiSlot input format from a data_feed.proto TEXT file.
The reference parses with protobuf text_format; this framework hand-rolls
its wire/text codecs (fluid/proto_wire.py precedent), so the text proto
is parsed directly — same fields: name, batch_size, pipe_command, and
multi_slot_desc.slots{name,type,is_dense,is_used,shape}."""

import re

__all__ = ["DataFeedDesc"]


class _Slot(object):
    def __init__(self):
        self.name = ""
        self.type = "uint64"
        self.is_dense = False
        # data_feed.proto defaults is_used to FALSE: slots are opted in
        # via set_use_slots (reference semantics)
        self.is_used = False
        self.shape = []


class DataFeedDesc(object):
    def __init__(self, proto_file):
        self.name = ""
        self.batch_size = 1
        self.pipe_command = "cat"
        self.slots = []
        with open(proto_file) as f:
            self._parse(f.read())
        self.__name_to_index = {s.name: i for i, s in enumerate(self.slots)}

    # -- text-proto parsing (the subset data_feed.proto uses) --
    def _parse(self, text):
        # the top-level name is any name field OUTSIDE the
        # multi_slot_desc block (text protos allow arbitrary field order)
        msd = re.search(r"multi_slot_desc\s*\{", text)
        if msd is not None:
            depth, end = 0, len(text)
            for i in range(msd.end() - 1, len(text)):
                if text[i] == "{":
                    depth += 1
                elif text[i] == "}":
                    depth -= 1
                    if depth == 0:
                        end = i + 1
                        break
            outside = text[:msd.start()] + text[end:]
        else:
            outside = text
        for m in re.finditer(r'name:\s*"([^"]+)"', outside):
            self.name = m.group(1)
        m = re.search(r"batch_size:\s*(\d+)", text)
        if m:
            self.batch_size = int(m.group(1))
        m = re.search(r'pipe_command:\s*"([^"]+)"', text)
        if m:
            self.pipe_command = m.group(1)
        for block in re.finditer(r"slots\s*\{([^}]*)\}", text):
            s = _Slot()
            body = block.group(1)
            for key, cast in (("name", str), ("type", str)):
                km = re.search(r'%s:\s*"([^"]+)"' % key, body)
                if km:
                    setattr(s, key, cast(km.group(1)))
            for key in ("is_dense", "is_used"):
                km = re.search(r"%s:\s*(\w+)" % key, body)
                if km:
                    setattr(s, key, km.group(1).lower() == "true")
            s.shape = [int(v) for v in re.findall(r"shape:\s*(-?\d+)", body)]
            self.slots.append(s)

    # -- reference API --
    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        if self.name != "MultiSlotDataFeed":
            raise ValueError(
                "Only MultiSlotDataFeed needs set_dense_slots, please "
                "check your datafeed.proto")
        for name in dense_slots_name:
            self.slots[self.__name_to_index[name]].is_dense = True

    def set_use_slots(self, use_slots_name):
        if self.name != "MultiSlotDataFeed":
            raise ValueError(
                "Only MultiSlotDataFeed needs set_use_slots, please "
                "check your datafeed.proto")
        for name in use_slots_name:
            self.slots[self.__name_to_index[name]].is_used = True

    def desc(self):
        """Text-proto dump (reference desc())."""
        lines = ['name: "%s"' % self.name,
                 "batch_size: %d" % self.batch_size,
                 'pipe_command: "%s"' % self.pipe_command,
                 "multi_slot_desc {"]
        for s in self.slots:
            lines.append("  slots {")
            lines.append('    name: "%s"' % s.name)
            lines.append('    type: "%s"' % s.type)
            lines.append("    is_dense: %s" % str(s.is_dense).lower())
            lines.append("    is_used: %s" % str(s.is_used).lower())
            for d in s.shape:
                lines.append("    shape: %d" % d)
            lines.append("  }")
        lines.append("}")
        return "\n".join(lines) + "\n"
