// Scriptable fake libSDL2 for testing the REAL ctypes marshalling layer of
// viewer/sdl_shell.py::SdlBackend (VERDICT r4 item 5).
//
// This image ships no libSDL2/display, so the window-open syscall stays
// environment-gated — but everything up to it (struct layouts, call
// sequences, pixel upload, joystick polling) is testable against this stub:
// it exports the ~19 SDL symbols SdlBackend binds, emits scripted SDL_Event
// structs whose layouts are INDEPENDENTLY hand-derived here from the SDL2
// ABI (SDL_events.h field orders; the C compiler computes the offsets, so a
// wrong ctypes offset on the Python side shows up as garbled fields), and
// records every call for the test to assert.
//
// Reference behavior being shimmed: sdl_viewer/src/lib.rs:350-611 (window +
// event pump + texture present); the real consumer is SdlBackend
// (viewer/sdl_shell.py:320-456).
//
// Build (lazily, by tests/test_sdl_stub.py):
//   g++ -shared -fPIC -O1 -o libsdl2_stub.so sdl2_stub.cpp

#include <cstdlib>
#include <cstring>

extern "C" {

typedef unsigned char Uint8;
typedef unsigned short Uint16;
typedef unsigned int Uint32;
typedef short Sint16;
typedef int Sint32;

// -- SDL2 ABI structs (SDL_events.h) ----------------------------------------

typedef struct {
  int scancode;  // SDL_Scancode enum
  Sint32 sym;    // SDL_Keycode
  Uint16 mod;
  Uint32 unused;
} SDL_Keysym;

typedef struct {
  Uint32 type;
  Uint32 timestamp;
  Uint32 windowID;
  Uint8 state;
  Uint8 repeat;
  Uint8 padding2;
  Uint8 padding3;
  SDL_Keysym keysym;
} SDL_KeyboardEvent;

typedef struct {
  Uint32 type;
  Uint32 timestamp;
  Uint32 windowID;
  Uint32 which;
  Uint32 state;
  Sint32 x;
  Sint32 y;
  Sint32 xrel;
  Sint32 yrel;
} SDL_MouseMotionEvent;

typedef struct {
  Uint32 type;
  Uint32 timestamp;
  Uint32 windowID;
  Uint32 which;
  Sint32 x;
  Sint32 y;
  Uint32 direction;
} SDL_MouseWheelEvent;

typedef struct {
  Uint32 type;
  Uint32 timestamp;
  Uint32 windowID;
  Uint8 event;  // SDL_WindowEventID
  Uint8 padding1;
  Uint8 padding2;
  Uint8 padding3;
  Sint32 data1;
  Sint32 data2;
} SDL_WindowEvent;

typedef union {
  Uint32 type;
  SDL_KeyboardEvent key;
  SDL_MouseMotionEvent motion;
  SDL_MouseWheelEvent wheel;
  SDL_WindowEvent window;
  Uint8 padding[56];  // sizeof(SDL_Event) == 56 in SDL2
} SDL_Event;

enum {
  STUB_SDL_QUIT = 0x100,
  STUB_SDL_WINDOWEVENT = 0x200,
  STUB_SDL_KEYDOWN = 0x300,
  STUB_SDL_KEYUP = 0x301,
  STUB_SDL_MOUSEMOTION = 0x400,
  STUB_SDL_MOUSEWHEEL = 0x403,
};

// -- scripted event queue -----------------------------------------------------
//
// Entries are either real events or a FRAME BARRIER (is_barrier): when the
// head is a barrier, SDL_PollEvent returns 0 once and consumes it — giving
// the test per-frame scripting exactly like the pure-python FakeBackend.

#define STUB_MAX_EVENTS 256

static struct {
  SDL_Event ev;
  int is_barrier;
} g_queue[STUB_MAX_EVENTS];
static int g_head = 0, g_tail = 0;

static SDL_Event *push_slot(void) {
  if (g_tail >= STUB_MAX_EVENTS) return NULL;
  g_queue[g_tail].is_barrier = 0;
  SDL_Event *e = &g_queue[g_tail++].ev;
  memset(e, 0, sizeof(*e));
  return e;
}

// -- recorded state -------------------------------------------------------

static struct {
  int init_result;
  Uint32 init_flags;
  int window_w, window_h;
  Uint32 window_flags;
  char window_title[128];
  int textures_created, textures_destroyed;
  int tex_w, tex_h, tex_access;
  Uint32 tex_format;
  int update_count, last_pitch;
  unsigned long long pixel_sum;  // of the last SDL_UpdateTexture upload
  int render_clear, render_copy, render_present;
  int renderer_destroyed, window_destroyed, quit_called;
  int joystick_count;
  char joystick_name[128];
  Sint16 axes[8];
  int axis_calls;
  int joystick_closed;
} g;

static int g_window_obj, g_renderer_obj, g_texture_obj, g_joystick_obj;

// -- control plane (called by the test through ctypes) ----------------------

void pcv_stub_reset(void) {
  memset(&g, 0, sizeof(g));
  g_head = g_tail = 0;
}

void pcv_stub_set_init_result(int rc) { g.init_result = rc; }

void pcv_stub_push_keydown(int scancode, Uint16 mod) {
  SDL_Event *e = push_slot();
  if (!e) return;
  e->key.type = STUB_SDL_KEYDOWN;
  e->key.state = 1;
  e->key.keysym.scancode = scancode;
  e->key.keysym.sym = scancode;  // sym unused by the consumer
  e->key.keysym.mod = mod;
}

void pcv_stub_push_keyup(int scancode) {
  SDL_Event *e = push_slot();
  if (!e) return;
  e->key.type = STUB_SDL_KEYUP;
  e->key.keysym.scancode = scancode;
}

void pcv_stub_push_mousemotion(Uint32 state, Sint32 x, Sint32 y, Sint32 xrel,
                               Sint32 yrel) {
  SDL_Event *e = push_slot();
  if (!e) return;
  e->motion.type = STUB_SDL_MOUSEMOTION;
  e->motion.state = state;
  e->motion.x = x;
  e->motion.y = y;
  e->motion.xrel = xrel;
  e->motion.yrel = yrel;
}

void pcv_stub_push_wheel(Sint32 y) {
  SDL_Event *e = push_slot();
  if (!e) return;
  e->wheel.type = STUB_SDL_MOUSEWHEEL;
  e->wheel.y = y;
}

void pcv_stub_push_windowevent(Uint8 which, Sint32 data1, Sint32 data2) {
  SDL_Event *e = push_slot();
  if (!e) return;
  e->window.type = STUB_SDL_WINDOWEVENT;
  e->window.event = which;
  e->window.data1 = data1;
  e->window.data2 = data2;
}

void pcv_stub_push_quit(void) {
  SDL_Event *e = push_slot();
  if (!e) return;
  e->type = STUB_SDL_QUIT;
}

void pcv_stub_push_frame_end(void) {
  if (g_tail >= STUB_MAX_EVENTS) return;
  g_queue[g_tail].is_barrier = 1;
  g_tail++;
}

void pcv_stub_set_joystick(const char *name) {
  g.joystick_count = 1;
  strncpy(g.joystick_name, name, sizeof(g.joystick_name) - 1);
}

void pcv_stub_set_axis(int axis, Sint16 value) {
  if (axis >= 0 && axis < 8) g.axes[axis] = value;
}

// getters
int pcv_stub_get(const char *what) {
  if (!strcmp(what, "window_w")) return g.window_w;
  if (!strcmp(what, "window_h")) return g.window_h;
  if (!strcmp(what, "window_flags")) return (int)g.window_flags;
  if (!strcmp(what, "init_flags")) return (int)g.init_flags;
  if (!strcmp(what, "textures_created")) return g.textures_created;
  if (!strcmp(what, "textures_destroyed")) return g.textures_destroyed;
  if (!strcmp(what, "tex_w")) return g.tex_w;
  if (!strcmp(what, "tex_h")) return g.tex_h;
  if (!strcmp(what, "tex_access")) return g.tex_access;
  if (!strcmp(what, "update_count")) return g.update_count;
  if (!strcmp(what, "last_pitch")) return g.last_pitch;
  if (!strcmp(what, "render_clear")) return g.render_clear;
  if (!strcmp(what, "render_copy")) return g.render_copy;
  if (!strcmp(what, "render_present")) return g.render_present;
  if (!strcmp(what, "renderer_destroyed")) return g.renderer_destroyed;
  if (!strcmp(what, "window_destroyed")) return g.window_destroyed;
  if (!strcmp(what, "quit_called")) return g.quit_called;
  if (!strcmp(what, "axis_calls")) return g.axis_calls;
  if (!strcmp(what, "joystick_closed")) return g.joystick_closed;
  return -0x7fffffff;
}

unsigned long long pcv_stub_tex_format(void) { return g.tex_format; }
unsigned long long pcv_stub_pixel_sum(void) { return g.pixel_sum; }
const char *pcv_stub_window_title(void) { return g.window_title; }

// -- the SDL2 API surface SdlBackend binds ----------------------------------

int SDL_Init(Uint32 flags) {
  g.init_flags = flags;
  return g.init_result;
}

const char *SDL_GetError(void) { return "stub-injected failure"; }

void *SDL_CreateWindow(const char *title, int x, int y, int w, int h,
                       Uint32 flags) {
  (void)x;
  (void)y;
  g.window_w = w;
  g.window_h = h;
  g.window_flags = flags;
  if (title) strncpy(g.window_title, title, sizeof(g.window_title) - 1);
  return &g_window_obj;
}

void *SDL_CreateRenderer(void *window, int index, Uint32 flags) {
  (void)window;
  (void)index;
  (void)flags;
  return &g_renderer_obj;
}

void *SDL_CreateTexture(void *renderer, Uint32 format, int access, int w,
                        int h) {
  (void)renderer;
  g.textures_created++;
  g.tex_format = format;
  g.tex_access = access;
  g.tex_w = w;
  g.tex_h = h;
  return &g_texture_obj;
}

int SDL_NumJoysticks(void) { return g.joystick_count; }

void *SDL_JoystickOpen(int index) {
  return index < g.joystick_count ? &g_joystick_obj : NULL;
}

const char *SDL_JoystickName(void *joystick) {
  (void)joystick;
  return g.joystick_name;
}

Sint16 SDL_JoystickGetAxis(void *joystick, int axis) {
  (void)joystick;
  g.axis_calls++;
  return (axis >= 0 && axis < 8) ? g.axes[axis] : 0;
}

void SDL_JoystickClose(void *joystick) {
  (void)joystick;
  g.joystick_closed++;
}

int SDL_PollEvent(SDL_Event *event) {
  if (g_head >= g_tail) return 0;
  if (g_queue[g_head].is_barrier) {
    g_head++;  // end of this frame's script
    return 0;
  }
  if (event) memcpy(event, &g_queue[g_head].ev, sizeof(SDL_Event));
  g_head++;
  return 1;
}

int SDL_UpdateTexture(void *texture, const void *rect, const void *pixels,
                      int pitch) {
  (void)texture;
  (void)rect;
  g.update_count++;
  g.last_pitch = pitch;
  g.pixel_sum = 0;
  const Uint8 *p = (const Uint8 *)pixels;
  long long total = (long long)g.tex_h * pitch;
  for (long long i = 0; i < total; i++) g.pixel_sum += p[i];
  return 0;
}

int SDL_RenderClear(void *renderer) {
  (void)renderer;
  g.render_clear++;
  return 0;
}

int SDL_RenderCopy(void *renderer, void *texture, const void *src,
                   const void *dst) {
  (void)renderer;
  (void)texture;
  (void)src;
  (void)dst;
  g.render_copy++;
  return 0;
}

void SDL_RenderPresent(void *renderer) {
  (void)renderer;
  g.render_present++;
}

void SDL_DestroyTexture(void *texture) {
  (void)texture;
  g.textures_destroyed++;
}

void SDL_DestroyRenderer(void *renderer) {
  (void)renderer;
  g.renderer_destroyed++;
}

void SDL_DestroyWindow(void *window) {
  (void)window;
  g.window_destroyed++;
}

void SDL_Quit(void) { g.quit_called++; }

}  // extern "C"
